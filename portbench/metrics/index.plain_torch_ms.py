"""index.plain_torch_ms: the device milliseconds a request spends in
kernels that are not the port's own: the rotation, the coarse ranking's
product, mask and top-k, and the glue between the stages. The port's own
kernels are every ``__global__`` function of the program's CUDA sources
(``nvdb_tpu_torch/kernels/csrc``), read from them when the metric loads, so
that a kernel added there needs no edit here."""

import re

from portbench import spec

CSRC = spec.ROOT / "nvdb_tpu_torch" / "kernels" / "csrc"
# ``__global__ void [__launch_bounds__(...)] name(``
_GLOBAL = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\s*\([^()]*\)\s*)?(\w+)\s*\(")


def port_kernels(csrc=CSRC) -> list:
    """The names of every kernel of the program's CUDA sources."""
    names = set()
    for path in sorted(csrc.glob("*.cu*")):
        names.update(_GLOBAL.findall(path.read_text()))
    return sorted(names)


PORT_KERNELS = [r"\b(" + "|".join(port_kernels()) + r")\b"]


def read(t):
    if not t.requests or not t.kernels():
        return None
    ours = t.kernel_seconds(PORT_KERNELS)
    every = sum(e - s for _, s, e, _ in t.kernels()) / 1e9
    return 1e3 * (every - ours) / len(t.requests)
