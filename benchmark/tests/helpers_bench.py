"""Small cells for the CPU tests: the published configurations with the
narrow widths of the program's own CPU tests, and tiny traffic."""

import copy
import json
import os

from benchmark.harness import spec

NARROW = dict(stem_channels=16, gru_hidden=32, noise_dim=16, attention_dim=32,
              attention_inner=160, postnet_channels=32, disc_base_channels=8,
              disc_max_channels=32)
TINY_TRAFFIC = {
    "grid-serve": dict(batch=2, lengths={"fixed": 4}, buckets=[4], check_per_shape=1),
    "grid-train": dict(batch=2, window=20, pool=3),
}
# The generators' paths that no committed cell takes yet, at a tiny size:
# clips of varying length in buckets (serving), and the LRS recipe's raw
# format, pipeline and step (training), with windows shorter than the clip
# masked.
VARIABLE = {
    "grid-serve": dict(traffic=dict(lengths={"lognormal": dict(median=5, sigma=0.45, min=2, max=8)},
                                    block=20, buckets=[4, 8])),
    "grid-train": dict(traffic=dict(dataset="lrs", raw_size=160,
                                    lengths={"lognormal": dict(median=20, sigma=0.45, min=8, max=40)}),
                       train=dict(amsgrad=False, sync_dis_weight=0.5, recon_on_denormalized=False,
                                  f_max=7600.0)),
}


def small_cell(name: str, variable: bool = False) -> spec.Cell:
    """The cell with tiny traffic (and, for training, narrow widths); with
    ``variable``, on the paths of ``VARIABLE``."""
    cell = copy.deepcopy(spec.load_cell(spec.load_benchmark(), name))
    entry = next(w for w in spec.load_benchmark()["workloads"] if w["name"] == name)
    cell.traffic.update(TINY_TRAFFIC[entry["traffic"]])
    if variable:
        cell.traffic.update(VARIABLE[entry["traffic"]]["traffic"])
        cell.config["train"].update(VARIABLE[entry["traffic"]].get("train", {}))
    if cell.traffic["kind"] == "train":
        cell.config["model"].update(NARROW)
    return cell


def load_json(path):
    with open(os.path.join(spec.ROOT, path)) as f:
        return json.load(f)
