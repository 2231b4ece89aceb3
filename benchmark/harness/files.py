"""The benchmark's data files, found by name.

    benchmark/workloads/<cell>.json   {"config": ..., "traffic": ..., "chips": 1}
    benchmark/configs/<config>.json   a deployment: its fixture, sha256, sizes
    benchmark/traffic/<traffic>.json  a mix: its runner and the runner's parameters

A cell is a workload file; adding one, or a configuration or a traffic mix,
is adding a file. `root` is the folder that holds the three directories
(this package's parent, or a test's own).
"""
from __future__ import annotations

import hashlib
import json
import re
from dataclasses import dataclass
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


class FixtureChanged(RuntimeError):
    """A configuration's fixture is missing or differs from its sha256."""


@dataclass
class Cell:
    name: str
    chips: int
    config: dict      # with "name"
    traffic: dict     # with "name"


def _read(root: Path, kind: str, name: str) -> dict:
    if not NAME.match(name):
        raise ValueError(f"{kind}: {name!r} is not a name")
    path = root / kind / f"{name}.json"
    with open(path) as f:
        data = json.load(f)
    return {**data, "name": name}


def load_cell(name: str, root: Path = BENCH) -> Cell:
    """The cell `name` with its configuration and traffic files read."""
    wl = _read(root, "workloads", name)
    return Cell(name=name, chips=int(wl.get("chips", 1)),
                config=_read(root, "configs", wl["config"]),
                traffic=_read(root, "traffic", wl["traffic"]))


def sha256(path: Path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def fixture_path(config: dict, root: Path = ROOT, prefix: str = "") -> Path:
    """The configuration's fixture (`<prefix>fixture`, e.g. its unsound
    proofs' with prefix "unsound_"), after checking its sha256
    (`<prefix>sha256`): a changed fixture fails the run rather than change
    the yardstick."""
    name, want = config[prefix + "fixture"], config[prefix + "sha256"]
    path = root / name
    if not path.is_file():
        raise FixtureChanged(f"{config['name']}: fixture {name} not found")
    got = sha256(path)
    if got != want:
        raise FixtureChanged(f"{config['name']}: {name} has sha256 {got}, "
                             f"the configuration states {want}")
    return path
