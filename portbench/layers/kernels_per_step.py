"""Device kernels a traced step."""


def read(t):
    return t.kernels_per_unit()
