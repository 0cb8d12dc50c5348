"""Entry ``fit``: one solo training run a call (``train.fit``) on one
device, its seed and weights the call's only lane."""

from portbench.entries._common import Called, device_dataset, one_device

devices = one_device
prepare = device_dataset


def call(prepared, cfg, seeds, weights) -> Called:
    from parallel_gcn_tpu_torch import train

    cfg.tpu.seed = seeds[0]
    res = train.fit(cfg, prepared.state, weights=weights[0], verbose=False)
    return Called(histories=[res.history], epochs_run=[res.epochs_run], replays=res.replays,
                  epoch_s=res.avg_epoch_time_s, graph_launches=dict(res.graph_launches))
