"""Data and tensor parallelism over ``torch.distributed``.

Port of ``consolver_tpu/dist/``.  The JAX package runs one program over a
device mesh and XLA inserts the collectives; here a rank is one process and
every collective is explicit:

* :mod:`consolver_torch.dist.mesh`: the (data, model) rank layout, process
  groups and the batch / parameter helpers;
* :mod:`consolver_torch.dist.tp`: Megatron column / row splits of the FLUX
  DiT and the SD UNet by regex rules over module paths;
* :mod:`consolver_torch.dist.launch`: one process per rank on this host,
  for tests and smoke runs (``torchrun`` launches real jobs).
"""
