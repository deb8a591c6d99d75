"""Fleet job utilities.

The port of ``paddle_tpu/incubate/fleet/utils/fleet_util.py`` (the
reference's ``fleet_util.py`` FleetUtil: rank-0 logging, the global AUC
over distributed stat buckets, model save and load around ``fluid.io``,
online pass-interval planning). The cross-worker sum of the AUC buckets
runs over ``torch.distributed`` when a process group is up, and is the
identity in a single process (the reference uses the role maker's MPI
all_reduce the same way).
"""
from __future__ import annotations

import logging
import os
import shutil
import tempfile

import numpy as np

from ....distributed.ps_rpc import host_array

__all__ = ["FleetUtil"]

_logger = logging.getLogger("FleetUtil")


class FleetUtil:
    """(reference fleet_util.py:53)"""

    def __init__(self, mode: str = "pslib", role_maker=None):
        self.mode = mode
        self._role_maker = role_maker

    # -- rank-0 logging ---------------------------------------------------
    def _worker_index(self) -> int:
        if self._role_maker is not None:
            return int(self._role_maker.worker_index())
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            return int(dist.get_rank())
        return int(os.environ.get("PADDLE_TRAINER_ID", "0"))

    def rank0_print(self, s: str) -> None:
        if self._worker_index() == 0:
            print(s, flush=True)

    def rank0_info(self, s: str) -> None:
        if self._worker_index() == 0:
            _logger.info(s)

    def rank0_error(self, s: str) -> None:
        if self._worker_index() == 0:
            _logger.error(s)

    # -- metric helpers ---------------------------------------------------
    def set_zero(self, var_name, scope=None, param_type="int64"):
        """Zero a metric accumulator var (the reference's
        fleet_util.py set_zero), where it lies."""
        import torch

        from ....core import global_scope

        scope = scope or global_scope()
        var = scope.find_var(var_name)
        if var is None or not var.is_initialized():
            return
        arr = var.raw().array
        var.get_tensor()._array = torch.zeros(
            tuple(arr.shape), dtype=getattr(torch, param_type),
            device=arr.device)

    def _all_reduce(self, arr: np.ndarray) -> np.ndarray:
        """Sum across workers; the identity in a single process."""
        import torch
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized() \
                and dist.get_world_size() > 1:
            t = torch.from_numpy(np.ascontiguousarray(arr))
            dist.all_reduce(t)
            return t.numpy()
        return arr

    def get_global_auc(self, scope=None, stat_pos="_generated_var_2",
                       stat_neg="_generated_var_3"):
        """Global AUC from the auc op's pos/neg bucket stats summed over
        all workers (reference fleet_util.py:186 — trapezoid over the
        bucketed ROC, walked from the highest-score bucket down)."""
        from ....core import global_scope

        scope = scope or global_scope()
        pv, nv = scope.find_var(stat_pos), scope.find_var(stat_neg)
        if pv is None or nv is None or not pv.is_initialized() \
                or not nv.is_initialized():
            self.rank0_print("not found auc bucket")
            return None
        global_pos = self._all_reduce(
            host_array(pv.raw().array).astype(np.float64).reshape(1, -1))
        global_neg = self._all_reduce(
            host_array(nv.raw().array).astype(np.float64).reshape(1, -1))

        num_bucket = global_pos.shape[1]
        area = pos = neg = 0.0
        total_ins_num = 0.0
        for i in range(num_bucket):
            index = num_bucket - 1 - i
            new_pos = pos + global_pos[0][index]
            total_ins_num += global_pos[0][index]
            new_neg = neg + global_neg[0][index]
            total_ins_num += global_neg[0][index]
            area += (new_neg - neg) * (pos + new_pos) / 2
            pos, neg = new_pos, new_neg
        if pos * neg == 0 or total_ins_num == 0:
            return 0.5
        return float(area / (pos * neg))

    def print_global_auc(self, scope=None, stat_pos="_generated_var_2",
                         stat_neg="_generated_var_3",
                         print_prefix=""):
        auc = self.get_global_auc(scope, stat_pos, stat_neg)
        self.rank0_print("%s global auc = %s" % (print_prefix, auc))
        return auc

    # -- model save/load around fluid.io ----------------------------------
    def save_paddle_inference_model(self, executor, scope, program,
                                    feeded_vars, target_vars,
                                    output_path, day, pass_id,
                                    hadoop_fs=None):
        """Save the inference model under the day/pass layout the
        reference's online pipeline uses (fleet_util.py:876), uploading
        via the fs client when given."""
        from .... import io as fluid_io
        from ....core import scope_guard

        staging = tempfile.mkdtemp(prefix="dnn_plugin_")
        try:
            local_dir = os.path.join(staging, "model")
            with scope_guard(scope):
                fluid_io.save_inference_model(
                    local_dir,
                    [v if isinstance(v, str) else v.name
                     for v in feeded_vars],
                    target_vars, executor, main_program=program)
            dest = "%s/%s/%s/dnn_plugin" % (output_path, day, pass_id)
            fs = hadoop_fs or _default_fs()
            if not fs.makedirs(os.path.dirname(dest) or "."):
                raise IOError("makedirs failed for %r" % dest)
            if not fs.upload(dest, local_dir, overwrite=True):
                raise IOError("upload failed for %r" % dest)
            return dest
        finally:
            shutil.rmtree(staging, ignore_errors=True)

    def save_paddle_params(self, executor, scope, program, model_name,
                           output_path, day, pass_id, var_names,
                           hadoop_fs=None):
        """Persist selected params (fleet_util.py:965)."""
        from .... import io as fluid_io
        from ....core import scope_guard

        staging = tempfile.mkdtemp(prefix="dnn_plugin_params_")
        try:
            local_dir = os.path.join(staging, "params")
            with scope_guard(scope):
                fluid_io.save_vars(
                    executor, local_dir, main_program=program,
                    vars=[program.global_block()._find_var_recursive(n)
                          for n in var_names])
            dest = "%s/%s/%s/%s" % (output_path, day, pass_id,
                                    model_name)
            fs = hadoop_fs or _default_fs()
            if not fs.makedirs(os.path.dirname(dest) or "."):
                raise IOError("makedirs failed for %r" % dest)
            if not fs.upload(dest, local_dir, overwrite=True):
                raise IOError("upload failed for %r" % dest)
            return dest
        finally:
            shutil.rmtree(staging, ignore_errors=True)

    def write_model_donefile(self, output_path, day, pass_id, xbox_base_key,
                             donefile_name="donefile.txt",
                             hadoop_fs=None):
        """Append the day/pass done record (fleet_util.py:362)."""
        if self._worker_index() != 0:
            return
        fs = hadoop_fs or _default_fs()
        model_path = "%s/%s/%s" % (output_path, day, pass_id)
        content = "%s\t%s\t%s\t%s\t%s" % (day, pass_id, xbox_base_key,
                                          model_path, int(pass_id) - 1)
        done = "%s/%s" % (output_path, donefile_name)
        prev = fs.cat(done) if fs.is_exist(done) else ""
        fd, tmp = tempfile.mkstemp(suffix=".donefile")
        try:
            with os.fdopen(fd, "w") as f:
                f.write((prev + "\n" if prev else "") + content + "\n")
            if not fs.makedirs(output_path):
                raise IOError("makedirs failed for %r" % output_path)
            if not fs.upload(done, tmp, overwrite=True):
                raise IOError("donefile upload failed for %r" % done)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
        return content

    def get_last_save_model(self, output_path,
                            donefile_name="donefile.txt",
                            hadoop_fs=None):
        """(day, pass_id, path) of the newest donefile record
        (fleet_util.py:1158); (-1, -1, "") when absent."""
        fs = hadoop_fs or _default_fs()
        done = "%s/%s" % (output_path, donefile_name)
        if not fs.is_exist(done):
            return -1, -1, ""
        lines = [l for l in fs.cat(done).splitlines() if l.strip()]
        if not lines:
            return -1, -1, ""
        cols = lines[-1].split("\t")
        return int(cols[0]), int(cols[1]), cols[3]

    # -- schedule planning -------------------------------------------------
    def get_online_pass_interval(self, days, hours, split_interval,
                                 split_per_pass,
                                 is_data_hourly_placed=False):
        """Partition a day's N-minute splits into training passes
        (reference fleet_util.py:1207). ``days``/``hours`` accept the
        brace-expansion strings the reference pipes through echo, or
        plain lists."""
        hours = _expand(hours)
        split_interval = int(split_interval)
        split_per_pass = int(split_per_pass)
        splits_per_day = 24 * 60 // split_interval
        left = int(hours[0])
        right = int(hours[-1])
        start = 0
        split_path = []
        for i in range(splits_per_day):
            h = start // 60
            m = start % 60
            if left <= h <= right:
                if is_data_hourly_placed:
                    split_path.append("%02d" % h)
                else:
                    split_path.append("%02d%02d" % (h, m))
            start += split_interval
        start = 0
        online_pass_interval = []
        while start < len(split_path):
            online_pass_interval.append(
                split_path[start:start + split_per_pass])
            start += split_per_pass
        return online_pass_interval


def _expand(spec):
    """'{0..23}' / '0 1 2' / list -> list of strings."""
    if isinstance(spec, (list, tuple)):
        return [str(s) for s in spec]
    s = str(spec).strip()
    if s.startswith("{") and ".." in s:
        a, b = s.strip("{}").split("..")
        return [str(i) for i in range(int(a), int(b) + 1)]
    return s.split()


def _default_fs():
    from ....core.fs import LocalFS

    return LocalFS()
