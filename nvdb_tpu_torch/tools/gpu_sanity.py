"""GPU hello-world: the device's properties, then a round trip through the
``add1`` kernel (the port of ``nvdb_tpu.tools.tpu_sanity``, the
nvdb_cuda_sanity analogue).

    python -m nvdb_tpu_torch.tools.gpu_sanity

Builds ``csrc/add1.cu``, adds one to an [8, 128] f32 tensor on the card and
checks the result against ``x + 1``: exit 0 when they are equal, 2 when
they differ. Without a card it exits 1: there is no CPU stand-in.
"""

from __future__ import annotations

import argparse
import sys

from nvdb_tpu_torch.tools._common import fail


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device: gpu_sanity checks a GPU and has no CPU mode")
    from nvdb_tpu_torch.kernels import add1

    n = torch.cuda.device_count()
    print(f"torch {torch.__version__} CUDA {torch.version.cuda} n_devices={n}")
    for i in range(n):
        pr = torch.cuda.get_device_properties(i)
        print(f"  device {i}: {pr.name} sm_{pr.major}{pr.minor} SMs={pr.multi_processor_count} "
              f"memory={pr.total_memory / 2 ** 30:.1f} GiB")

    dev = torch.device("cuda", torch.cuda.current_device())
    x = torch.arange(8 * 128, dtype=torch.float32, device=dev).reshape(8, 128) * 0.5
    y = add1.add1_cuda(x)
    ok = torch.equal(y, add1.add1_reference(x))
    print(f"add1 kernel: {'OK' if ok else 'MISMATCH'}")
    sys.exit(0 if ok else 2)


if __name__ == "__main__":
    main()
