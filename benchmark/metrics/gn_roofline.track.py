"""The GN roofline: the least time of the profiled slice's aligns (the
frozen byte and flop counts of ``benchmark/roofline.py`` at the engine's
input precision, against 3.35 TB/s and 67 TFLOP/s) over the device busy time
of everything the align span put on the card, in %. Kernel names play no
part."""


def read(ctx):
    busy = (ctx.trace or {}).get("busy_by_label", {}).get("align")
    if not busy or ctx.least_align_s is None:
        return None
    return 100.0 * ctx.least_align_s / busy
