from .cellgrid import (CellGrid, bucket_fields, global_positions,
                       rebucket_offsets)

__all__ = ["CellGrid", "bucket_fields", "global_positions",
           "rebucket_offsets"]
