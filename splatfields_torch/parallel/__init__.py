"""Multi-device training on ``torch.distributed`` (counterpart of
``splatfields_tpu/parallel/``): ``mesh`` (the [data, model] rank grid and
its process groups, the collectives the step differentiates through),
``step`` (the sharded training step, on-mesh densify, sharding and
replication of the train state) and ``ring`` (Gaussian blocks passed
around the model ring against fixed tile slices)."""
