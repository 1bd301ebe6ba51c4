"""The JAX package's example drivers (examples/), ported: an OpenMC-style
host driver (``openmc_style_driver``), two concurrent clients of one
``TallyService`` (``multi_client_service``) and a multi-shard partitioned
campaign with autotuning and a checkpoint (``multichip_checkpointed_run``).

Run one as ``python -m pumiumtally_tpu_torch.examples.<name>``; each runs
on the card unless ``--device cpu`` is given, and refuses to run without
a GPU otherwise. Each has ``main(argv=None)`` and a ``run`` function that
takes the sizes, and nothing runs on import."""
