"""field_kernel_ms (layer: field; moves verified_proofs_per_s): the device
ms a batch of the field plane's kernels named below (ops/field_kernel's
five elementwise kernels and ops/witness_kernel's two inverses), in the
traced stretch."""
UNIT = "ms"
NAMES = ("gl_mul", "gl_add", "gl_sub", "gl_mul_add", "gl_mul_small", "gl_inv", "ext2_inv")
KERNELS = r"(?<![A-Za-z0-9_])(%s)_kernel(?![A-Za-z0-9_])" % "|".join(NAMES)


def read(run):
    if run.trace is None:
        return None
    t = run.trace.device_s(KERNELS)
    return t / run.trace.batches * 1e3 if t > 0 else None
