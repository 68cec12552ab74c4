"""Entry points of the port: ``python -m repro_torch.launch.serve`` replays
a trace through a ``ServingSession``, ``python -m repro_torch.launch.gateway``
serves one over HTTP/SSE. Both run ``TorchEngine`` on the card unless
``--device cpu`` is given, or the discrete-event simulator (``--engine
sim``). ``python -m repro_torch.launch.train`` trains a model, on the
card unless ``--device cpu`` is given. The dry-run tools —
``python -m repro_torch.launch.dryrun``, ``roofline`` and ``hillclimb``,
over ``steps``, ``counting`` and ``collectives`` — trace each step on fake
tensors as rank 0 of a fake process group of 256 or 512 ranks."""
