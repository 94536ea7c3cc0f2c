"""The GN roofline of the live server: the least time of the profiled
slice's aligns (the frozen byte and flop counts of ``benchmark/roofline.py``
at each step's real pairs, the pad pairs left out, and each level's valid
source pixels, against 3.35 TB/s and 67 TFLOP/s) over the device busy time
of the slice's whole steps (everything a step put on the card: upload,
filter, pyramid, the gathers, the align and the readback), in %. Kernel
names play no part."""


def read(ctx):
    busy = (ctx.trace or {}).get("busy_by_label", {}).get("step")
    if not busy or ctx.least_align_s is None:
        return None
    return 100.0 * ctx.least_align_s / busy
