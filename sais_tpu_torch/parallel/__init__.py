"""Parallelism on torch.distributed: device meshes and batch sharding
(`mesh`), process groups and multi-host meshes (`distributed`), ring
attention over a sequence axis (`sequence`) and the tensor-parallel ViT
forward (`tp`).  Counterpart of `sais_tpu/parallel/`.

JAX runs one process over many devices; PyTorch runs one process per
device, in a process group.  A mesh here is a
`torch.distributed.device_mesh.DeviceMesh` over the group's ranks with
the JAX package's axis names.  Every module imports torch.distributed at
first use of a collective, never a GPU at import.
"""
