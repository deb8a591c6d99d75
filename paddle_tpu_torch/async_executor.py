"""AsyncExecutor + DataFeedDesc.

The port of ``paddle_tpu/async_executor.py`` (the reference's
``async_executor.py``, the legacy file-driven async trainer, and
``data_feed_desc.py`` over the MultiSlotDataFeed prototext). The
reference drives C++ ExecutorThreadWorker threads over DataFeed files;
here the same contract routes through ``dataset_module``'s MultiSlot
reader into ``Executor.train_from_dataset``. The class stays because
user scripts construct it; new code should call
``Executor.train_from_dataset``, as the reference's own deprecation
path says.
"""
from __future__ import annotations

import re
from typing import List

from . import framework
from .core import global_scope
from .executor import Executor


class DataFeedDesc:
    """Parse the reference's MultiSlotDataFeed prototext into slot
    metadata (data_feed_desc.py contract: set_batch_size,
    set_dense_slots, set_use_slots, desc())."""

    def __init__(self, proto_file_path: str):
        with open(proto_file_path) as f:
            self._text = f.read()
        self.batch_size = 1
        m = re.search(r"batch_size\s*:\s*(\d+)", self._text)
        if m:
            self.batch_size = int(m.group(1))
        # top-level text only (slot blocks stripped) — a slot's name
        # must not be mistaken for the feed name
        body = re.sub(r"multi_slot_desc\s*\{.*\}", "", self._text,
                      flags=re.S)
        m = re.search(r'name\s*:\s*"([^"]+)"', body)
        self.name = m.group(1) if m else "MultiSlotDataFeed"
        # top-level fields we don't model (pipe_command etc.) survive
        # the desc() round-trip verbatim
        self._extra_lines = [
            ln.strip() for ln in body.splitlines()
            if ln.strip() and not re.match(
                r'(name|batch_size)\s*:', ln.strip())]
        # slots: name/type/is_dense/is_used blocks in declaration order
        self.slots = []
        for block in re.findall(r"slots\s*\{([^}]*)\}", self._text):
            name = re.search(r'name\s*:\s*"([^"]+)"', block)
            stype = re.search(r'type\s*:\s*"([^"]+)"', block)
            dense = re.search(r"is_dense\s*:\s*(\w+)", block)
            used = re.search(r"is_used\s*:\s*(\w+)", block)
            self.slots.append({
                "name": name.group(1) if name else "",
                "type": stype.group(1) if stype else "uint64",
                "is_dense": bool(dense and dense.group(1) == "true"),
                "is_used": bool(used and used.group(1) == "true"),
            })
        self._slot_by_name = {s["name"]: s for s in self.slots}

    def set_batch_size(self, batch_size: int):
        self.batch_size = int(batch_size)

    def set_dense_slots(self, dense_slots_name: List[str]):
        for n in dense_slots_name:
            self._slot_by_name[n]["is_dense"] = True

    def set_use_slots(self, use_slots_name: List[str]):
        for n in use_slots_name:
            self._slot_by_name[n]["is_used"] = True

    def desc(self) -> str:
        """Regenerate the prototext from current state (the reference
        rebuilds from its proto, so setters are reflected)."""
        lines = ['name: "%s"' % self.name,
                 "batch_size: %d" % self.batch_size]
        lines += self._extra_lines
        lines.append("multi_slot_desc {")
        for s in self.slots:
            lines += ["  slots {",
                      '    name: "%s"' % s["name"],
                      '    type: "%s"' % s["type"],
                      "    is_dense: %s" % str(s["is_dense"]).lower(),
                      "    is_used: %s" % str(s["is_used"]).lower(),
                      "  }"]
        lines.append("}")
        return "\n".join(lines) + "\n"


class AsyncExecutor:
    """(the reference's async_executor.py) ``run`` trains a program over
    a filelist with a multi-slot feed; ``thread_num`` maps to worker
    threads. Like every entry point of the port it runs on the card
    unless given ``CPUPlace()``."""

    def __init__(self, place=None, run_mode=""):
        self.place = place
        self.executor = Executor(place)

    def run(self, program, data_feed, filelist, thread_num=1, fetch=None,
            mode="", debug=False, scope=None):
        from .dataset_module import DatasetFactory

        program = program or framework.default_main_program()
        scope = scope or global_scope()
        if isinstance(filelist, str):
            filelist = [filelist]
        block = program.global_block()

        dataset = DatasetFactory().create_dataset("QueueDataset")
        if isinstance(data_feed, DataFeedDesc):
            dataset.set_batch_size(data_feed.batch_size)
            use_vars = [block.var(s["name"]) for s in data_feed.slots
                        if s["is_used"]]
        else:  # an already-configured fluid.dataset object
            return self.executor.train_from_dataset(
                program=program, dataset=data_feed, scope=scope,
                thread=thread_num, fetch_list=fetch, debug=debug)
        dataset.set_use_var(use_vars)
        dataset.set_thread(thread_num)
        dataset.set_filelist(filelist)
        return self.executor.train_from_dataset(
            program=program, dataset=dataset, scope=scope,
            thread=thread_num, fetch_list=fetch, debug=debug)
