#!/usr/bin/env python
"""Where K1's force sums on the Sod shock part from a float64 evaluation.

Runs the port's Sod example (``examples/sodshock.py``, flat backend) to
``--tend`` under ``--scheme``, then evaluates its force pass four ways on
the final state: the CUDA kernel (on the card), the plain torch version
in float32, the plain version in float64 (the launch's tiles in float64)
and the float64 sum of each term's magnitude (each slot's scale).  It
prints each sum's worst error from float64, in units of that scale, over
the live slots and over the empty ones (padding: pad-filled h = 1, so
they accept every row of their nine columns), with the accepted pairs
of the worst slot.

Then, for the ``--slots`` slots where the kernel's ``--sum`` (u_dt by
default) is furthest from float64, live ones and empty ones
(``--empty``), it rebuilds the slot's pair terms
in the kernel's order (the 9 column offsets, each offset's two row
ranges, rows ascending) with the plain body, in float32 and in float64,
and prints per slot:

* ``seq32``: the f32 terms added one by one in f32, as a kernel thread
  does (``== kernel``: bit for bit);
* ``terms64``: the same f32 terms added in float64 (what the f32 pair
  evaluation alone costs);
* the plain version's value (its rows summed by ``torch.sum``), the
  float64 truth, the pair count, the scale and the largest partial sum
  of the sequence.

The report goes to ``chiprun_out/torch_sum_order_<scheme>[_empty].json``;
with ``--dump`` (``..._pairs.json``) it holds the worst slot's pairs in
the kernel's order (dx, r2, r_inv, the f32 and f64 terms and the partial
sums).

    python tools/torch_sum_order.py [--scheme minimal] [--n 64]
        [--tend 0.2] [--slots 8] [--empty] [--dump] [--cpu]

On the CPU (``--cpu``) the kernel column is left out.
"""

import argparse
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

OUT_DIR = "chiprun_out"


def slot_pairs(L, body, slot, dtype):
    """The pair terms of i slot ``slot`` in the kernel's order: (terms
    (n_pairs, n_sum), dx (n_pairs, 3), r2 (n_pairs,))."""
    import torch
    from swift_subtask_dev_tpu_torch.ops import pair_flat as pf
    Ncol, W, F = L.ncx * L.ncy, L.W, len(body.fields)
    fidx = {n: i for i, n in enumerate(body.fields)}
    col, rem = divmod(slot, W)
    tile = rem // pf.LANES
    xi = L.Xi.to(dtype)[:, slot]                     # (F,)
    xa = L.Xa.to(dtype).reshape(Ncol, L.Wj, F)
    nbr = pf._nbr_table(L.ncx, L.ncy)
    terms, dxs, r2s = [], [], []
    for o, (ox, oy) in enumerate(pf.OFFSETS_9):
        xj = xa[int(nbr[col, o])]                     # (Wj, F)
        sx = float(np.float32(ox * L.ex))
        sy = float(np.float32(oy * L.ey))
        for k in range(2):
            w = int(L.ranges[col, tile, o, k])
            lo = (w & 0xFFFF) * pf.GRAN
            hi = lo + ((w >> 16) & 0xFFFF) * pf.GRAN
            rows = xj[lo:min(hi, L.Wj)]
            if rows.shape[0] == 0:
                continue

            def sf(name):
                return xi[fidx[name]].reshape(1)

            def nf(name):
                return rows[:, fidx[name]]
            dz = sf("off2") - nf("off2")
            dz = dz - L.boxz * torch.round(dz * (1.0 / L.boxz))
            dx = (sf("off0") - (nf("off0") + sx),
                  sf("off1") - (nf("off1") + sy), dz)
            r2 = dx[0] * dx[0] + dx[1] * dx[1] + dx[2] * dx[2]
            ok_extra, sums, _ = body.fn(sf, nf, dx, r2)
            ok = (nf("mask") > 0) & (r2 > 0) & ok_extra
            terms.append(torch.stack([torch.broadcast_to(v, r2.shape)
                                      for v in sums], -1)[ok])
            dxs.append(torch.stack(dx, -1)[ok])
            r2s.append(r2[ok])
    return torch.cat(terms), torch.cat(dxs), torch.cat(r2s)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scheme", default="minimal")
    ap.add_argument("--n", type=int, default=64)
    ap.add_argument("--tend", type=float, default=0.2)
    ap.add_argument("--y-aspect", type=float, default=0.5)
    ap.add_argument("--sum", type=int, default=3,
                    help="the force sum to trace (3: u_dt)")
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--empty", action="store_true",
                    help="trace the worst empty slots, not live ones")
    ap.add_argument("--dump", action="store_true")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)

    import torch
    from swift_subtask_dev_tpu_torch.examples import sodshock
    from swift_subtask_dev_tpu_torch.models.sph.sphenix import CosmoFactors
    from swift_subtask_dev_tpu_torch.ops import hydro_flat
    from swift_subtask_dev_tpu_torch.ops import pair_flat as pf

    on_card = not args.cpu
    if on_card and not torch.cuda.is_available():
        print("no CUDA device (use --cpu)", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0) if on_card else torch.device("cpu")
    card = "cpu"
    if on_card:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip().splitlines()[0]
    eng, res = sodshock.run_sod(args.n, args.tend, args.scheme,
                                device=dev, y_aspect=args.y_aspect)
    print(f"Sod {args.scheme} n = {args.n}: "
          f"{res['steps']} steps to t = {res['t']:.4f}, L1(rho)/mean "
          f"{res['l1_rho']:.5f} [{card}]")
    pp = hydro_flat.force_pass(eng.state, eng.sph, CosmoFactors.no_cosmo())
    L, body = pf.prepare(eng.grid, pp), pp.body
    L64 = dataclasses.replace(L, Xi=L.Xi.double(), Xa=L.Xa.double())

    def abs_fn(sf, nf, dx, r2):
        ok, sums, maxes = body.fn(sf, nf, dx, r2)
        return ok, [torch.abs(v) for v in sums], maxes
    stats = {}
    p32 = pf.pair_apply_plain(L, body, stats).double()
    pairs = stats["slot_pairs"]
    p64 = pf.pair_apply_plain(L64, body)
    scale = pf.pair_apply_plain(
        L64, dataclasses.replace(body, fn=abs_fn)).clamp_min(1e-300)
    k32 = pf.pair_apply_kernel(L, body).double() if on_card else None
    live = (eng.state["mask"].reshape(-1) > 0).to(dev)

    # the slots of live tiles (the plain version zeroes the others)
    walked = pairs > 0
    report = {"scheme": args.scheme, "n": args.n,
              "t": res["t"], "card": card, "sums": []}
    for q in range(body.n_sum):
        row = {"sum": q}
        for name, x in (("kernel", k32), ("plain32", p32)):
            if x is None:
                continue
            e = (x[q] - p64[q]).abs() / scale[q]
            for where, sel in (("live", live), ("empty", walked & ~live)):
                if bool(sel.any()):
                    i = int(torch.argmax(torch.where(sel, e, -1.0)))
                    row[f"{name}_{where}"] = e[i].item()
                    row[f"{name}_{where}_pairs"] = int(pairs[i])
        report["sums"].append(row)
        print(f"  force sum {q}: worst |x - f64| / sum|t| (the slot's "
              f"pairs): " + ", ".join(
                  f"{k} {v:.3e} ({row[k + '_pairs']})"
                  for k, v in row.items()
                  if k != "sum" and not k.endswith("_pairs")))
    q = args.sum
    ref = k32 if on_card else p32
    among = (walked & ~live) if args.empty else live
    err = torch.where(among, (ref[q] - p64[q]).abs() / scale[q], -1.0)
    worst = torch.topk(err, args.slots).indices.tolist()
    report["slots"] = []
    for rank, slot in enumerate(worst):
        t32, dx, r2 = slot_pairs(L, body, slot, torch.float32)
        t64, _, _ = slot_pairs(L64, body, slot, torch.float64)
        terms = t32[:, q].cpu().numpy()
        acc = np.float32(0.0)
        partial = []
        for v in terms:
            acc = np.float32(acc + v)
            partial.append(float(acc))
        sc = scale[q, slot].item()
        truth = p64[q, slot].item()
        row = {"slot": slot, "live": bool(live[slot]),
               "pairs": int(len(terms)), "scale": sc,
               "f64": truth, "plain32": p32[q, slot].item(),
               "seq32": float(acc),
               "terms64": float(terms.astype(np.float64).sum()),
               "terms64_vs_f64": float(
                   (t32[:, q].double() - t64[:, q]).sum().item()),
               "max_partial": float(np.max(np.abs(partial)))}
        if on_card:
            row["kernel"] = k32[q, slot].item()
            row["seq32_is_kernel"] = bool(np.float32(row["kernel"])
                                          == np.float32(acc))
        report["slots"].append(row)
        print(f"  {'live' if row['live'] else 'empty'} slot {slot}: "
              f"{row['pairs']} pairs, sum|t| {sc:.4e}, "
              f"f64 {truth:.6e}; (x - f64)/sum|t|: "
              + (f"kernel {(row['kernel'] - truth) / sc:+.3e}, "
                 if on_card else "")
              + f"seq32 {(row['seq32'] - truth) / sc:+.3e}, plain32 "
              f"{(row['plain32'] - truth) / sc:+.3e}, f32 terms in f64 "
              f"{(row['terms64'] - truth) / sc:+.3e}; largest partial sum "
              f"{row['max_partial'] / sc:.3f} sum|t|"
              + (f"; seq32 == kernel: {row['seq32_is_kernel']}"
                 if on_card else ""))
        if args.dump and rank == 0:
            r_inv = torch.rsqrt(r2)
            report["worst_pairs"] = {
                "dx": dx.tolist(), "r2": r2.tolist(),
                "r_inv": r_inv.tolist(), "terms32": t32.tolist(),
                "terms64": t64.tolist(), "partial32": partial}
    os.makedirs(OUT_DIR, exist_ok=True)
    path = os.path.join(
        OUT_DIR, f"torch_sum_order_{args.scheme}"
        f"{'_empty' if args.empty else ''}{'_pairs' if args.dump else ''}"
        ".json")
    with open(path, "w") as f:
        json.dump(report, f)
    print(f"wrote {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
