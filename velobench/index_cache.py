"""The built Vamana graph of a deployment, kept per (configuration, seed of
its data: the configuration's ``data_seed``, or the run's).

A deployment of an SSD-resident index opens the index it built; it does not
build it again.  The host build of 10 000 vertices takes minutes, so the
first run of a seed in a checkout builds and writes
``cache/<config>-<seed>-<key>.npz`` (about 2 MB; ``cache/`` is ignored by
git), and later runs of that seed there load it.  ``key`` hashes the base
vectors, the build's parameters and the source of the port's build
(``vamana.py``), so an entry never serves other data, and a change to the
build is measured on the graph it builds.  A built graph is written and
read back before it is used, so a run that built and a run that loaded hold
the same objects.
Arrays only: the file is read with ``allow_pickle=False``."""

from __future__ import annotations

import hashlib
import json
import os
import time
from pathlib import Path

import numpy as np

from velobench import registry

CACHE_DIR = registry.HERE / "cache"


def build_source() -> bytes:
    """The source of the port's Vamana build."""
    from repro_torch.core import vamana

    return Path(vamana.__file__).read_bytes()


def key(base: np.ndarray, params: dict) -> str:
    h = hashlib.sha256(json.dumps(params, sort_keys=True).encode())
    h.update(build_source())
    h.update(np.ascontiguousarray(base).tobytes())
    return h.hexdigest()[:16]


def path(config: str, seed: int, base: np.ndarray, params: dict,
         cache_dir: Path | None = None) -> Path:
    name = f"{registry.check_name(config)}-{int(seed)}-{key(base, params)}.npz"
    return Path(cache_dir or CACHE_DIR) / name


def save(graph, dest: Path) -> None:
    keys = np.asarray(list(graph.affinity.keys()), dtype=np.int64)
    lists = [graph.affinity[int(k)] for k in keys]
    sizes = np.asarray([len(x) for x in lists], dtype=np.int64)
    flat = [p for x in lists for p in x]
    dest.parent.mkdir(parents=True, exist_ok=True)
    tmp = dest.with_name(f"{dest.name}.{os.getpid()}.tmp")
    with open(tmp, "wb") as f:
        np.savez(
            f, adjacency=graph.adjacency, degrees=graph.degrees,
            medoid=np.int64(graph.medoid), R=np.int64(graph.R), tau=np.float64(graph.tau),
            aff_keys=keys, aff_sizes=sizes,
            aff_ids=np.asarray([int(v) for v, _ in flat], dtype=np.int64),
            aff_d2=np.asarray([float(d) for _, d in flat], dtype=np.float64),
        )
    os.replace(tmp, dest)


def load(src: Path):
    from repro_torch.core.vamana import VamanaGraph

    with np.load(src, allow_pickle=False) as z:
        ids, d2 = z["aff_ids"].tolist(), z["aff_d2"].tolist()
        affinity, at = {}, 0
        for k, s in zip(z["aff_keys"].tolist(), z["aff_sizes"].tolist()):
            affinity[k] = list(zip(ids[at:at + s], d2[at:at + s]))
            at += s
        return VamanaGraph(
            adjacency=z["adjacency"].copy(), degrees=z["degrees"].copy(),
            medoid=int(z["medoid"]), R=int(z["R"]), affinity=affinity, tau=float(z["tau"]),
        )


def load_or_build(config: str, seed: int, base: np.ndarray, params: dict, build,
                  log=print, cache_dir: Path | None = None):
    """The graph of (config, seed) from the cache, built by ``build()`` and
    written there first when it is not."""
    dest = path(config, seed, base, params, cache_dir)
    if not dest.is_file():
        t0 = time.perf_counter()
        graph = build()
        log(f"velobench: built the Vamana graph of {config} seed {seed} in "
            f"{time.perf_counter() - t0:.3f} s")
        save(graph, dest)
        del graph
    return load(dest)
