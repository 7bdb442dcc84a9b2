"""Sharded matching over a grid of devices (the port of
``halo2_regex_tpu.parallel``): ``mesh`` (``make_mesh``, ``Mesh``,
``initialize_distributed``), ``data_parallel`` (``DistributedMatcher``),
``seq_parallel`` (``SeqShardedMatcher``, ``SpeculativeSeqMatcher``) and
the multi-process corpus scan ``launch``."""
