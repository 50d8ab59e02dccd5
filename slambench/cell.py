"""A cell of `BENCHMARK.json` and the files it names, found by name.

    BENCHMARK.json            the cells ("workloads") and the metrics
    slambench/configs/<c>.json   a deployment: preset, overrides, sensor
    slambench/traffic/<t>.json   a mix: scene, trajectory, noise, loop
    slambench/limits/<w>.json    the limits `correct` holds a cell to
    slambench/metrics/<m>.py     one reader a metric (`read(run)`)

A configuration may name prior sessions, as the system takes them:
"system": {"previous_maps": [names]}. Its traffic file then describes
them, one a name in that order (`slambench.sessions` writes them in
set-up):

    "prior_sessions"  trajectories through the cell's scene, each with the
                      keys of "trajectory", its "start" and its "scans"
    "prior_error"     {"t_m", "yaw_deg"}: the seeded error of the saved
                      poses, one rigid motion a session after the first
    "prior_v6"        the variance row every saved scan carries
    "prior_edges"     {"radius_m", "yaw_deg", "every"}: the rule that picks
                      the edges between prior sessions in edge.txt

Any trajectory, the live one's included, may start elsewhere than the
origin: "start": [x, y, z, yaw] (metres, radians; `sim.place`).
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict            # the configuration file
    traffic: dict           # the traffic file
    end_to_end: list        # BENCHMARK.json entries this cell reports
    per_layer: list
    limits: dict

    def slam_config(self):
        """The port's SlamConfig: the preset with the file's overrides."""
        from voxelslam_tpu_torch import config as vc
        return vc.override(vc.preset(self.config["preset"]),
                           self.config.get("overrides", {}))

    def sensor(self, cfg) -> dict:
        """The sensor block with what the decoders and the generator take
        from the SlamConfig: blind radius, decimation, extrinsic."""
        return dict(self.config["sensor"], blind=cfg.odom.blind,
                    point_filter_num=cfg.odom.point_filter_num,
                    extrinsic_R=list(cfg.extrinsic_R),
                    extrinsic_t=list(cfg.extrinsic_t))


def _load(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def reports(metric: dict, cell: str, e2e_of_cell: set) -> bool:
    """Whether `cell` reports `metric`: named in its "workloads", or,
    without that key, an end-to-end metric or one that moves an
    end-to-end metric the cell reports."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves") in e2e_of_cell if "moves" in metric else True


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell `name` of `root`/BENCHMARK.json with its files under
    `root`/slambench."""
    root = Path(root)
    here = root / "slambench"
    bench = _load(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has "
                         f"{sorted(cells)}")
    w = cells[name]
    e2e = [m for m in bench["end_to_end"] if reports(m, name, set())]
    names = {m["name"] for m in e2e}
    pl = [m for m in bench["per_layer"] if reports(m, name, names)]
    lim_path = here / "limits" / f"{name}.json"
    return Cell(name=name, chips=int(w["chips"]),
                config=_load(here / "configs" / f"{w['config']}.json"),
                traffic=_load(here / "traffic" / f"{w['traffic']}.json"),
                end_to_end=e2e, per_layer=pl,
                limits=_load(lim_path) if lim_path.exists() else {})


def metric_reader(name: str, root: Path = ROOT):
    """`slambench/metrics/<name>.py`'s `read` function."""
    path = Path(root) / "slambench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "slambench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
