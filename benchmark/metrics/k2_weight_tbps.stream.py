"""The rate at which K2's rows launches stream their weights, in TB/s: the
program's count of weight bytes a call's launch reads
(`cell_process.weight_bytes`: its build's weight buffers once a tile and
frame) over K2's mean device time a call in the traced window. Set against
the card's L2 and memory rates, it tells a launch bound by its weight
stream from one bound by its multiply-adds. Nothing to read after a units
launch (0 bytes counted), or where the program keeps no such count."""


def read(ctx):
    try:
        from deepfilternet_torch.ops.whole_cell import cell_process
    except ImportError:
        return None
    nbytes = getattr(cell_process, "weight_bytes", None)
    t = getattr(ctx, "k2_per_call", None)
    if not nbytes or not t:
        return None
    return nbytes / t / 1e12
