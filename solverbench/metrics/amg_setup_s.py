"""The configuration's setup call, from the host CSR matrix to the
hierarchy on the device, closed by a device synchronise (host clock)."""


def read(run):
    return run.amg_setup_s
