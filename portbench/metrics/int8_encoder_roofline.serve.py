"""The int8 encoder's share of its roofline: the least time of its work,
counted per ConvBlock as a unit (``counts/work.py``), over the device time
of every kernel under its ``encoder`` range, in %.  Nothing to read in a
cell whose encoder is not int8."""

from portbench.counts import work


def read(ctx):
    if ctx.mix.get("encoder") != "int8":
        return None
    s = ctx.trace.kernel_s_in("encoder")
    if not s:
        return None
    m, conf = ctx.mix, ctx.conf
    least = work.int8_encoder_least_s(conf["encodermodel"], m["batch"], m["t_mel"],
                                      conf["data_dim"], conf["encoder_args"]["embed_size"])
    return 100.0 * least / (s / ctx.units)
