"""dispatch.launches_per_req: the device kernels in the traced window over
the requests in it, the port's kernels and plain torch's alike (copies and
sets not counted)."""


def read(t):
    if not t.requests or not t.kernels():
        return None
    return len(t.kernels()) / len(t.requests)
