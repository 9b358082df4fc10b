"""setup_s: seconds from the start of the process to the start of the
window: imports, inputs made from the seed, the program's warm-up of the
cell's shapes (its layouts captured as CUDA graphs; in a checkout's first
run also the kernels' nvcc build). Host clock."""


def read(ctx):
    return ctx.setup_s
