"""Entry points and the production dry-run: ``python -m
repro_torch.launch.train``, ``.serve``, ``.dryrun`` and ``.raven_dryrun``;
``mesh`` (device meshes) and ``cost_analysis`` (the dispatch-mode cost
counter, the counterpart of the JAX package's ``hlo_analysis``)."""
