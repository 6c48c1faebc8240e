"""Parallelism of the PyTorch port on ``torch.distributed`` (port of
``ssr_speech_tpu/parallel``): the launch helpers (:mod:`.dist`), the
``(dp, tp)`` rank mesh and its sharding rules (:mod:`.mesh`), Megatron's
tensor- and sequence-parallel operators (:mod:`.collectives`) and the GPipe
pipeline (:mod:`.pipeline`)."""
