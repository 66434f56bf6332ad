"""Device kernels a traced request."""


def read(t):
    return t.kernels_per_unit()
