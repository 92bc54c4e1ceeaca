"""Parallelism on torch.distributed: the JAX package's `parallel/`.

- `distributed`: the WORLD_SIZE / RANK rendezvous (NCCL, gloo on the CPU).
- `mesh`: the (data, model, pipe) `DeviceMesh`, batch sharding, the
  Megatron TP placement rule and the ZeRO / FSDP partition rule, and the
  scope that tells the model which groups it runs over.
- `collectives`: eval sharding and gathers, the metric all-reduce, and the
  autograd-aware collectives the parallel model paths use.
- `activation_sharding`: sequence parallelism's scatter / gather along L.
- `pipeline`: GPipe over the `pipe` ranks, and stacking of layer trees.
- `sharded_retrieval`: the streaming, row-sharded coarse retrieval stage.

Submodules import nothing at package import: `models.layers` imports
`collectives` and `mesh`, which import torch only.
"""
