"""A traffic's entry: the program's call that the window drives, one module
a name (``entries/<name>.py``), found by the ``entry`` of the traffic file.

A module gives three functions, which the harness calls in this order:

- ``devices(cell, require_cuda) -> list[torch.device]``: the devices the cell
  runs on, the first of them the one that holds the weights and the
  reference; ``SystemExit`` where the machine lacks the chips the cell asks
  for (``require_cuda`` false: the CPU, for the tests);
- ``prepare(cell, cfg, devices) -> _common.Prepared``: the program's set-up
  from the cached data, with its stage seconds and the graph's sizes;
- ``call(prepared, cfg, seeds, weights) -> _common.Called``: one training
  run of every seed in ``seeds`` (one a lane) from ``weights`` (a list of
  float32 leaves a lane), returning what the program reports.
"""
