"""The harness's span around the first load of the port's four kernel
libraries (``repro_torch.kernels.build``), their build included where the
checkout's cache holds none yet."""


def read(run):
    return run.spans.get("kernel_load")
