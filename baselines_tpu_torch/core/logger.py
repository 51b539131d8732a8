"""Key-value metrics logger: the port's own copy of baselines_tpu/core/logger.py.

Same contract as baselines/logger.py: ``logkv`` last-wins, ``logkv_mean`` running
mean, ``dumpkvs`` writes the accumulated row to every output format and clears it;
formats are the human table, json-lines, csv and tensorboard scalars (written by
``torch.utils.tensorboard``, which needs the tensorboard package, imported where the
format is made). When several processes form a
``torch.distributed`` group, ``dumpkvs`` is collective: the row is the count-weighted
mean over the processes and process 0 alone writes it (logger.py:226-248);
``configure_for_process`` gives the other processes a log of their own. ``profile_kv``
and ``profile`` add a block's wall-clock seconds to the row's ``wait_<scope>`` key.
"""

from __future__ import annotations

import csv
import datetime
import json
import os
import os.path as osp
import sys
import tempfile
import time
from collections import defaultdict
from contextlib import contextmanager

from baselines_tpu_torch.distributed.collectives import (host_weighted_mean, process_count,
                                                         process_index)

DEBUG = 10
INFO = 20
WARN = 30
ERROR = 40
DISABLED = 50


class KVWriter:
    def writekvs(self, kvs):
        raise NotImplementedError

    def close(self):
        pass


class SeqWriter:
    def writeseq(self, seq):
        raise NotImplementedError


class HumanOutputFormat(KVWriter, SeqWriter):
    """Boxed two-column table (logger.py:27-74)."""

    def __init__(self, filename_or_file):
        if isinstance(filename_or_file, str):
            self.file = open(filename_or_file, "wt")
            self.own_file = True
        else:
            self.file = filename_or_file
            self.own_file = False

    @staticmethod
    def _cell(v):
        return f"{v:<8.3g}" if hasattr(v, "__float__") else str(v)

    @staticmethod
    def _truncate(s, maxlen=30):
        return s[: maxlen - 3] + "..." if len(s) > maxlen else s

    def writekvs(self, kvs):
        cells = [
            (self._truncate(k), self._truncate(self._cell(v)))
            for k, v in sorted(kvs.items(), key=lambda kv: kv[0].lower())
        ]
        if not cells:
            return
        kw = max(len(k) for k, _ in cells)
        vw = max(len(v) for _, v in cells)
        rule = "-" * (kw + vw + 7)
        body = "".join(f"| {k.ljust(kw)} | {v.ljust(vw)} |\n" for k, v in cells)
        self.file.write(f"{rule}\n{body}{rule}\n")
        self.file.flush()

    def writeseq(self, seq):
        self.file.write(" ".join(map(str, seq)) + "\n")
        self.file.flush()

    def close(self):
        if self.own_file:
            self.file.close()


class JSONOutputFormat(KVWriter):
    """One JSON object per row (logger.py:77-91)."""

    def __init__(self, filename):
        self.file = open(filename, "wt")

    def writekvs(self, kvs):
        out = {k: float(v) if hasattr(v, "__float__") else v for k, v in sorted(kvs.items())}
        self.file.write(json.dumps(out) + "\n")
        self.file.flush()

    def close(self):
        self.file.close()


class CSVOutputFormat(KVWriter):
    """CSV with a grow-only column set (logger.py:94-136): a metric that appears late
    gets a column, and the rows written before it are rewritten with a blank there."""

    def __init__(self, filename):
        self.filename = filename
        self.file = open(filename, "wt", newline="")
        self.keys: list[str] = []
        self.writer = None

    def writekvs(self, kvs):
        row = {k: ("" if v is None else v) for k, v in kvs.items()}
        fresh = sorted(set(row) - set(self.keys))
        if fresh:
            self.file.flush()
            with open(self.filename, "rt", newline="") as f:
                old_rows = list(csv.DictReader(f))
            self.keys += fresh
            self.file.close()
            self.file = open(self.filename, "wt", newline="")
            self.writer = csv.DictWriter(self.file, fieldnames=self.keys, restval="")
            self.writer.writeheader()
            self.writer.writerows(old_rows)
        self.writer.writerow(row)
        self.file.flush()

    def close(self):
        self.file.close()


class TensorBoardOutputFormat(KVWriter):
    """Each row's numeric values as tensorboard scalars at step 1, 2, ... of the rows
    (logger.py:162-180)."""

    def __init__(self, logdir):
        from torch.utils.tensorboard import SummaryWriter

        os.makedirs(logdir, exist_ok=True)
        self.writer = SummaryWriter(log_dir=logdir)
        self.step = 1

    def writekvs(self, kvs):
        for k, v in kvs.items():
            if hasattr(v, "__float__"):
                self.writer.add_scalar(k, float(v), self.step)
        self.writer.flush()
        self.step += 1

    def close(self):
        self.writer.close()


def make_output_format(fmt, ev_dir, log_suffix=""):
    """logger.py:174-187."""
    os.makedirs(ev_dir, exist_ok=True)
    if fmt == "stdout":
        return HumanOutputFormat(sys.stdout)
    if fmt == "log":
        return HumanOutputFormat(osp.join(ev_dir, f"log{log_suffix}.txt"))
    if fmt == "json":
        return JSONOutputFormat(osp.join(ev_dir, f"progress{log_suffix}.json"))
    if fmt == "csv":
        return CSVOutputFormat(osp.join(ev_dir, f"progress{log_suffix}.csv"))
    if fmt == "tensorboard":
        return TensorBoardOutputFormat(osp.join(ev_dir, f"tb{log_suffix}"))
    raise ValueError(f"Unknown format specified: {fmt}")


class Logger:
    CURRENT = None  # type: Logger

    def __init__(self, dir, output_formats):
        self.name2val = defaultdict(float)
        self.name2cnt = defaultdict(int)
        self.level = INFO
        self.dir = dir
        self.output_formats = output_formats

    def logkv(self, key, val):
        self.name2val[key] = val

    def logkv_mean(self, key, val):
        if val is None:
            self.name2val[key] = None
            return
        oldval, cnt = self.name2val[key], self.name2cnt[key]
        self.name2val[key] = oldval * cnt / (cnt + 1) + float(val) / (cnt + 1)
        self.name2cnt[key] = cnt + 1

    def dumpkvs(self):
        """Write the row and clear it. With several processes it is collective, every
        process calling it as often: the row is the count-weighted mean over them, and
        process 0 alone writes it."""
        d = dict(self.name2val)
        write = self.level != DISABLED
        if process_count() > 1:
            d = host_weighted_mean({k: (v, self.name2cnt.get(k, 1)) for k, v in d.items()})
            write = write and process_index() == 0
        if write:
            for fmt in self.output_formats:
                if isinstance(fmt, KVWriter):
                    fmt.writekvs(d)
        self.name2val.clear()
        self.name2cnt.clear()
        return d

    def log(self, *args, level=INFO):
        if self.level <= level:
            for fmt in self.output_formats:
                if isinstance(fmt, SeqWriter):
                    fmt.writeseq(map(str, args))

    def set_level(self, level):
        self.level = level

    def get_dir(self):
        return self.dir

    def close(self):
        for fmt in self.output_formats:
            fmt.close()


def configure(dir=None, format_strs=None, log_suffix=""):
    """logger.py:372-399; env vars BTPU_LOGDIR / BTPU_LOG_FORMAT, with OPENAI_LOGDIR /
    OPENAI_LOG_FORMAT as fallbacks."""
    if dir is None:
        dir = os.getenv("BTPU_LOGDIR") or os.getenv("OPENAI_LOGDIR")
    if dir is None:
        dir = osp.join(tempfile.gettempdir(),
                       datetime.datetime.now().strftime("btpu-%Y-%m-%d-%H-%M-%S-%f"))
    os.makedirs(dir, exist_ok=True)
    if format_strs is None:
        fmt_env = os.getenv("BTPU_LOG_FORMAT") or os.getenv("OPENAI_LOG_FORMAT")
        format_strs = fmt_env.split(",") if fmt_env else ["stdout", "log", "csv"]
    output_formats = [make_output_format(f, dir, log_suffix) for f in format_strs if f]
    Logger.CURRENT = Logger(dir=dir, output_formats=output_formats)
    if output_formats:
        log(f"Logging to {dir}")


def configure_for_process(process_index: int, dir=None, format_strs=None):
    """Process 0 logs everything; the others log to ``log-proc<index>.txt`` in the same
    dir (logger.py:295-304). Theirs are muted, not disabled: they still take part in
    the collective ``dumpkvs``."""
    if process_index == 0:
        configure(dir=dir, format_strs=format_strs)
    else:
        configure(dir=dir, format_strs=format_strs or ["log"],
                  log_suffix=f"-proc{process_index:03d}")


def _get_current():
    if Logger.CURRENT is None:
        Logger.CURRENT = Logger(dir=None, output_formats=[HumanOutputFormat(sys.stdout)])
    return Logger.CURRENT


def logkv(key, val):
    _get_current().logkv(key, val)


def logkv_mean(key, val):
    _get_current().logkv_mean(key, val)


def logkvs(d):
    for k, v in d.items():
        logkv(k, v)


def dumpkvs():
    return _get_current().dumpkvs()


def getkvs():
    return dict(_get_current().name2val)


def log(*args, level=INFO):
    _get_current().log(*args, level=level)


def debug(*args):
    log(*args, level=DEBUG)


def info(*args):
    log(*args, level=INFO)


def warn(*args):
    log(*args, level=WARN)


def error(*args):
    log(*args, level=ERROR)


def set_level(level):
    _get_current().set_level(level)


def get_dir():
    return _get_current().get_dir()


def reset():
    if Logger.CURRENT is not None:
        Logger.CURRENT.close()
    Logger.CURRENT = None


@contextmanager
def profile_kv(scopename):
    """Add the block's wall-clock seconds to the row's ``wait_<scopename>`` (the host's
    clock: device work the block only enqueues is not waited for)."""
    logkey = "wait_" + scopename
    tstart = time.time()
    try:
        yield
    finally:
        _get_current().name2val[logkey] += time.time() - tstart


def profile(n):
    """The decorator form of ``profile_kv``: ``@profile("name")`` adds each call's
    seconds to ``wait_name``."""

    def decorator_with_name(func):
        def func_wrapper(*args, **kwargs):
            with profile_kv(n):
                return func(*args, **kwargs)

        return func_wrapper

    return decorator_with_name
