"""The one-sided layer: the symmetric heap (``symm``) under the device-side
language of ``csrc/shmem.cuh``."""
