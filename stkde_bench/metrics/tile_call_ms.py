"""Inputs and plan: ``convert.buckets_to_torch``, the tile loads back to the
host, ``kernels/stkde_tile.py::stkde_tiles_cuda`` until it returns (host
planning and launches), ms (staged query, median)."""


def read(rec):
    return rec.stage_ms("tile_call")
