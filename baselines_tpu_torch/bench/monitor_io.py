"""Episode-stats CSV files (a copy of baselines_tpu/bench/monitor_io.py, which imports
no JAX; the port imports nothing of the JAX package) — parity with
baselines/bench/monitor.py's ResultsWriter (:100-120) and load_results (:126-163): a
`*.monitor.csv` per writer with a JSON header line `#{"t_start":..., "env_id":...}` and
columns r,l,t; loaders glob a directory and return pandas frames with t re-based to the
earliest start."""

from __future__ import annotations

import csv
import glob
import json
import os
import os.path as osp
import time

EXT = "monitor.csv"


class ResultsWriter:
    def __init__(self, filename, header=None, extra_keys=()):
        self.extra_keys = extra_keys
        header = dict(header or {})
        header.setdefault("t_start", time.time())
        if not filename.endswith(EXT):
            filename = (
                osp.join(filename, EXT) if osp.isdir(filename) else filename + "." + EXT
            )
        os.makedirs(osp.dirname(osp.abspath(filename)), exist_ok=True)
        self.f = open(filename, "wt")
        self.f.write("#%s\n" % json.dumps(header))
        self.logger = csv.DictWriter(self.f, fieldnames=("r", "l", "t") + tuple(extra_keys))
        self.logger.writeheader()
        self.f.flush()

    def write_row(self, epinfo):
        self.logger.writerow(epinfo)
        self.f.flush()

    def close(self):
        self.f.close()


def load_results(dir):
    """monitor.py:126-163: concatenated, time-sorted episode frame."""
    import pandas

    monitor_files = sorted(
        glob.glob(osp.join(dir, "*" + EXT)) + glob.glob(osp.join(dir, "*monitor.json"))
    )
    if not monitor_files:
        raise LoadMonitorResultsError(
            f"no monitor files of the form *{EXT} found in {dir}"
        )
    dfs, headers = [], []
    for fname in monitor_files:
        with open(fname, "rt") as fh:
            firstline = fh.readline()
            assert firstline[0] == "#"
            header = json.loads(firstline[1:])
            df = pandas.read_csv(fh, index_col=None)
            headers.append(header)
            df["t"] += header["t_start"]
        dfs.append(df)
    df = pandas.concat(dfs)
    df.sort_values("t", inplace=True)
    df.reset_index(inplace=True, drop=True)
    df["t"] -= min(h["t_start"] for h in headers)
    df.headers = headers
    return df


class LoadMonitorResultsError(Exception):
    pass
