"""nvdb_tpu_torch — the PyTorch + CUDA port of nvdb_tpu for NVIDIA Hopper.

The layout mirrors ``nvdb_tpu`` module for module, so each counterpart sits
at the same path. Two paths are ported: the exact flat scan, and IVF-OPQ-PQ
with exact refine (build, ADC candidates, rerank):

- ``formats``  — vecbin64 / raw12 / gtbin, bit-compatible with ``nvdb_tpu``'s
                 files (bf16 payloads are ``np.uint16`` bits on the host),
                 plus seeded synthetic data.
- ``store``    — padded dtype-aware (f32 / bf16 / int8 + scales) store on an
                 explicit torch device.
- ``kernels``  — plain PyTorch ops (the CPU path and the oracles), k-means
                 and PQ training, and the hand-written CUDA kernels for
                 sm_90a (flat top-k, IVF-PQ ADC top-k, exact rerank), built
                 with nvcc at first use.
- ``index``    — ``FlatIndex`` (with the exact-i8 refine mode), exact ground
                 truth, ``IVFPQIndex`` and the IVF helpers it uses.
- ``dist``     — row-sharded search over a mesh of devices (one process
                 holding a tensor per shard, or several over
                 ``torch.distributed``), each shard on the same kernels.
- ``eval``     — stats, recall and the benchmark harness (numpy only).
- ``tools``    — the ``bench``, ``ivf_build`` and ``ivf_eval`` CLIs.

Importing the package loads no kernel library and imports neither jax nor
ml_dtypes.
"""

__version__ = "0.1.0"

from nvdb_tpu_torch.formats import vecbin, gtbin  # noqa: F401
from nvdb_tpu_torch.store import VectorStore  # noqa: F401
from nvdb_tpu_torch.index.flat import FlatIndex, build_ground_truth  # noqa: F401
