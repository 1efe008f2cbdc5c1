"""Scaling past one pair at a time (counterpart of the JAX package's
``parallel/``): the pair pool (``batch``: source pairs round-robin over
devices and CUDA streams), the lockstep multi-stream engine (``streams``),
the stream farm (``farm``: one worker thread and CUDA stream a stream),
the layer- and row-sharded step over a ``torch.distributed`` process
group (``sharding``) and its multi-process dry run (``dryrun``)."""
