"""Constants of the 27-cell neighbour stencil.

Copies of the reference's ``ops/stencil.py`` constants; its XLA loops
(``timebin_loop`` and the roll-stencil backend) are not ported.
"""

# "no neighbour" sentinel of the time-bin min reductions (> any real bin,
# small enough that sentinel + 2 cannot overflow i32)
NBIN_SENTINEL = 64

# The 27 stencil offsets, self first: the order the packed pair kernel
# walks the neighbour cells.
STENCIL_27 = [(0, 0, 0)] + [
    (dx, dy, dz)
    for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1)
    if not (dx == 0 and dy == 0 and dz == 0)
]
