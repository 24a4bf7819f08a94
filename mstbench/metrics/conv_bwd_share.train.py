"""Share of the device's operation time in the window taken by cuDNN's
convolution backward kernels (weight and data gradients: names holding
``wgrad`` or ``dgrad``)."""


def read(ctx):
    if ctx.trace is None:
        return None
    total = sum(b - a for _, a, b, _ in ctx.trace.ops)
    bwd = sum(b - a for n, a, b, _ in ctx.trace.ops
              if "wgrad" in n.lower() or "dgrad" in n.lower())
    return 100.0 * bwd / total if total and bwd else None
