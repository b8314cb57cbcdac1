"""Device milliseconds a build of PyTorch's own kernels: the front half's
elementwise ops, the CUB sort, the gathers, the `cat`s and the PLOC driver's
glue. A kernel is PyTorch's when its name lies in PyTorch's namespaces `at::`
or `at_cuda_detail::` (its copy of CUB); the port's hand kernels, memcpys and
memsets are not counted, so the pattern is frozen here and no file added
elsewhere changes what it reads."""

PATTERN = r"^(void )?at(_cuda_detail)?::"


def read(ctx):
    if not ctx.trace.count(PATTERN):
        return None
    return 1e3 * ctx.trace.seconds(PATTERN, cats=("kernel",)) / ctx.steps
