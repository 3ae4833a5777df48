"""cassandra_tpu_torch — the PyTorch/CUDA port of cassandra_tpu.

The package keeps the JAX package's module paths, so each module's
counterpart sits under the same name (`ops/merge.py`,
`ops/device_write.py`, `compaction/task.py`, ...). Modules without device
work are copies with their imports rebased; the device programs of the
JAX package are hand-written CUDA kernels for Hopper (`csrc/*.cu`, built
with nvcc into a shared library with a plain C interface and loaded with
ctypes, see `ops/cuda_lib.py`), each with a plain PyTorch version beside
it in the same module.

The device is explicit (`device.py`): entry points take `device=` and
default to `cuda`; without a card they raise, and they run the plain
PyTorch versions on the CPU only when the caller passes `device="cpu"`.

The package imports `torch` and never `jax`, and nothing of
`cassandra_tpu`.
"""

__version__ = "0.1.0"
