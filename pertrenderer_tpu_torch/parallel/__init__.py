"""Scale-out over torch.distributed (PyTorch port of
``pertrenderer_tpu/parallel``): ``sharding`` (the (data, samples) device
mesh, the sample group's average, the sharded pose step and the
multi-rank dry run) and ``distributed`` (process-group start-up and the
(slice, data, samples) mesh)."""
