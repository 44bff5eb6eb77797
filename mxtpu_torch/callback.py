"""Training callbacks — port of ``mxtpu/callback.py``: ``BatchEndParam``,
``Speedometer``, ``do_checkpoint``, ``log_train_metric`` and
``ProgressBar``.

``Speedometer`` reads the port's device-feed and communication counters
(``profiler``) and the step ring of ``observability.flops``, which
``Module.fit`` fills. ``do_checkpoint`` takes a path prefix; the
``CheckpointManager`` form needs ``checkpoint/manager.py``'s manager,
which is not ported, and raises ``NotImplementedError``.
"""

from __future__ import annotations

import logging
import os
import time
from typing import NamedTuple, Optional

__all__ = ["BatchEndParam", "Speedometer", "do_checkpoint",
           "log_train_metric", "ProgressBar", "no_checkpoint_manager"]


class BatchEndParam(NamedTuple):
    epoch: int
    nbatch: int
    eval_metric: object
    locals: Optional[dict] = None


def no_checkpoint_manager(what: str) -> NotImplementedError:
    """The refusal of a ``CheckpointManager`` argument."""
    return NotImplementedError(
        f"{what}: CheckpointManager (mxtpu/checkpoint/manager.py) is not "
        f"ported; pass a path prefix for the prefix-####.params layout")


class Speedometer:
    """Samples a second every ``frequent`` batches, logged with the
    metric; with a device feed running, the input stall a batch and the
    queue's high-water mark; with steps recorded by ``Module.fit``, the
    rolling p50/p99 step time."""

    def __init__(self, batch_size: int, frequent: int = 50,
                 auto_reset: bool = True):
        self.batch_size = batch_size
        self.frequent = frequent
        self.auto_reset = auto_reset
        self.init = False
        self.tic = 0.0
        self.last_count = 0
        self._feed_consumed = 0
        self._feed_stall_ms = 0.0
        self._comm_steps = 0
        self._comm_bytes = 0

    def _feed_msg(self) -> str:
        from . import profiler
        f = profiler.get_feed_stats()
        consumed = f["batches_consumed"] - self._feed_consumed
        stall = f["stall_ms_total"] - self._feed_stall_ms
        self._feed_consumed = f["batches_consumed"]
        self._feed_stall_ms = f["stall_ms_total"]
        if consumed <= 0:
            return ""
        return (f"\tinput-stall: {stall / consumed:.2f} ms/batch "
                f"(queue hw {f['queue_depth_max']}/{f['feed_depth']})")

    def _step_msg(self) -> str:
        from .observability import flops
        s = flops.get_mfu_stats()
        if not s["steps"]:
            return ""
        return (f"\tstep: p50={s['p50_step_ms']:.2f} ms "
                f"p99={s['p99_step_ms']:.2f} ms")

    def _comm_msg(self) -> str:
        from . import profiler
        c = profiler.get_comm_stats()
        steps = c["zero_steps"] - self._comm_steps
        total = c["bytes_reduced"] + c["bytes_gathered"]
        delta = total - self._comm_bytes
        self._comm_steps = c["zero_steps"]
        self._comm_bytes = total
        if steps <= 0:
            return ""
        return (f"\tcomm: {delta / steps / 1e6:.2f} MB/step "
                f"(ZeRO-1 dp={c['dp']}, {c['bucket_count']} bucket(s), "
                f"shard {c['shard_bytes_per_device'] / 1e6:.2f} MB/dev)")

    def __call__(self, param: BatchEndParam):
        count = param.nbatch
        if self.last_count > count:
            self.init = False
        self.last_count = count
        if self.init:
            if count % self.frequent == 0:
                elapsed = max(time.time() - self.tic, 1e-9)
                speed = self.frequent * self.batch_size / elapsed
                extra = self._feed_msg() + self._comm_msg() + self._step_msg()
                if param.eval_metric is not None:
                    nv = param.eval_metric.get_name_value()
                    if self.auto_reset:
                        param.eval_metric.reset()
                    msg = "\t".join(f"{n}={v:.6f}" for n, v in nv)
                    logging.info("Epoch[%d] Batch [%d]\tSpeed: %.2f "
                                 "samples/sec\t%s%s", param.epoch, count,
                                 speed, msg, extra)
                else:
                    logging.info("Epoch[%d] Batch [%d]\tSpeed: %.2f "
                                 "samples/sec%s", param.epoch, count, speed,
                                 extra)
                self.tic = time.time()
        else:
            self.init = True
            self.tic = time.time()


def do_checkpoint(prefix, period: int = 1, module=None, trainer=None):
    """Epoch-end callback writing ``prefix-symbol.json`` and
    ``prefix-{epoch + 1:04d}.params`` every ``period`` epochs (atomically,
    through ``checkpoint.save_legacy``)."""
    if not isinstance(prefix, (str, os.PathLike)):
        raise no_checkpoint_manager("do_checkpoint")
    period = max(1, int(period))

    def _callback(epoch, sym, arg_params, aux_params):
        if (epoch + 1) % period == 0:
            from .model import save_checkpoint
            save_checkpoint(str(prefix), epoch + 1, sym, arg_params,
                            aux_params)

    return _callback


def log_train_metric(period: int, auto_reset: bool = False):
    def _callback(param: BatchEndParam):
        if param.nbatch % period == 0 and param.eval_metric is not None:
            nv = param.eval_metric.get_name_value()
            msg = "\t".join(f"{n}={v:.6f}" for n, v in nv)
            logging.info("Iter[%d] Batch[%d] Train-%s", param.epoch,
                         param.nbatch, msg)
            if auto_reset:
                param.eval_metric.reset()

    return _callback


class ProgressBar:
    def __init__(self, total: int, length: int = 80):
        self.total = total
        self.length = length

    def __call__(self, param: BatchEndParam):
        filled = int(round(self.length * param.nbatch / float(self.total)))
        bar = "=" * filled + "-" * (self.length - filled)
        print(f"\r[{bar}] {param.nbatch}/{self.total}", end="", flush=True)
