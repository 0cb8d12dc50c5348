"""Entry ``fit_seeds``: one seed batch a call (``seeds.fit_seeds``) on one
device, a lane for each seed, each from its own weights."""

from portbench.entries._common import Called, device_dataset, one_device

devices = one_device
prepare = device_dataset


def call(prepared, cfg, seeds, weights) -> Called:
    from parallel_gcn_tpu_torch import seeds as port_seeds

    res = port_seeds.fit_seeds(cfg, prepared.state, seeds, weights=weights, verbose=False)
    return Called(histories=list(res.history), epochs_run=list(res.epochs_run),
                  replays=res.replays, epoch_s=res.avg_epoch_time_s,
                  graph_launches=dict(res.graph_launches))
