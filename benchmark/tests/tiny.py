"""The cells' files at a size the CPU tests hold: every width and count
shrunk, the keys and the loops as they are. The extraction cell keeps its
network whole (fc6 needs the 224-pixel input's 7 x 7 map) and shrinks its
traffic to 2 clips of 2 frames of 30 x 40 pixels a request.

The caption mix (``traffic/caption-b96.json``) has no cell yet; its tiny
runs name it ``lstm.caption`` or ``gru.caption`` and take that
configuration, with the logit-gap limits its loop was calibrated to on
the card at B=512 (PERF.md)."""

from benchmark import harness

WIDTHS = dict(feat_dim=16, length=6, dim_hidden=64, dim_embed=64, vocab_size=256, train_clips=16)
CAPTION = {"lstm.caption": ("s2vt-lstm-msvd", {"logit_gap": 5e-06}),
           "gru.caption": ("s2vt-gru-msvd", {"logit_gap": 2e-05})}
EXTRACT = dict(frames_per_clip=2, frame_h=30, frame_w=40, clip_batch=2, pool_clips=4,
               warmup_requests=1, traced_requests=1, check_requests=2)


def _caption_files(workload: str) -> tuple:
    config, limits = CAPTION[workload]
    cfg = harness.load_json(harness.HERE / "configs" / f"{config}.json")
    traffic = harness.load_json(harness.HERE / "traffic" / "caption-b96.json")
    cell = {"name": workload, "config": config, "traffic": "caption-b96", "chips": 1}
    return cell, cfg, traffic, limits


def tiny_files(workload: str) -> tuple:
    """(entry, config, traffic, limits) of ``workload`` at the tiny size."""
    if workload in CAPTION:
        cell, cfg, traffic, limits = _caption_files(workload)
    else:
        cell, cfg, traffic, limits = harness.cell_files(harness.benchmark_spec(), workload)
    if traffic["loop"] == "extract":
        return cell, cfg, dict(traffic, **EXTRACT), limits
    traffic = dict(traffic, batch=4)
    if traffic["loop"] == "train":
        traffic.update(valid_clips=4, traced_epochs=1)
    else:
        traffic.update(pool_clips=16, traced_requests=2, check_requests=2, warmup_requests=1)
    return cell, dict(cfg, **WIDTHS), traffic, limits
