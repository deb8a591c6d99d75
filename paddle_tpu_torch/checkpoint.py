"""Atomic, verifiable, rotated checkpoints.

Counterpart of ``paddle_tpu/checkpoint.py:73-589`` and ``:862-881``, with
the same files, manifest and layout, so a checkpoint written by either
package verifies and loads in the other. The contract:

- **atomicity**: a checkpoint is written into a temp dir next to its
  final name, every file is fsynced, a manifest with each file's sha256
  is written last, and the temp dir renames into place. A crash never
  leaves a torn hybrid: a NEW checkpoint name (the rotation manager's
  only case) appears all or nothing; overwriting an existing name has one
  rename-wide window where only that name is absent (older rotations
  still serve ``load_latest``, and the next save sweeps the stranded
  dirs). ``.tmp-`` names are invisible to the rotation scan.
- **verifiability**: ``verify_manifest`` recomputes each listed file's
  sha256; a mismatch or a missing file raises the typed
  ``CheckpointCorrupt``, not a parse error three frames deep.
- **rotation**: ``CheckpointManager`` keeps the newest ``keep``
  checkpoints under ``root/ckpt-<step>/`` with an atomically updated
  ``latest`` pointer; ``load_latest`` walks newest to oldest past corrupt
  entries, so one bad shard costs one checkpoint, not the run.
- **incremental saves**: ``save_incremental`` reuses unchanged shards of
  the previous checkpoint by content hash (or a caller's fingerprint,
  which skips even producing the bytes): a reused shard is hardlinked
  (copied where ``os.link`` fails) instead of re-serialized and
  re-fsynced. Every checkpoint dir stays self-contained.

``io.py``'s var-level saves and inference models use this module's
manifest and atomic writes: there is one copy of that code.

``checkpoint.save_ms`` / ``checkpoint.bytes`` / ``checkpoint.delta_bytes``
/ ``checkpoint.shards_reused`` / ``checkpoint.corrupt`` record into the
observability registry unconditionally, as in the JAX package. The
round-fenced ``RoundStore`` and
the ``job_*`` restore functions come with the parameter server.
"""
from __future__ import annotations

import contextlib
import hashlib
import json
import os
import shutil
import threading
import time
from typing import Callable, Dict, List, Optional

from . import observability as _obs
from .observability import flight as _flight

__all__ = ["CheckpointCorrupt", "MANIFEST_NAME", "SCOPE_VARS_NAME",
           "atomic_write_bytes", "atomic_checkpoint_dir",
           "makedirs_durable", "write_manifest", "verify_manifest",
           "manifest_extra", "load_scope_snapshot", "CheckpointManager",
           "save_checkpoint", "load_checkpoint"]

MANIFEST_NAME = "__manifest__.json"
SCOPE_VARS_NAME = "__vars__.json"  # file name -> var name (snapshots)
_LATEST_NAME = "latest"
_CKPT_PREFIX = "ckpt-"


class CheckpointCorrupt(RuntimeError):
    """A checkpoint failed integrity verification (missing file, size or
    sha256 mismatch, unreadable manifest). Callers holding older rotations
    should fall back; callers without one should fail loudly rather than
    train from garbage."""


def _observe(name: str, v) -> None:
    _obs.histogram(name).observe(v)


def _count(name: str, n: int = 1, **labels) -> None:
    _obs.counter(name, **labels).inc(n)


def _fsync_file(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _fsync_dir(path: str) -> None:
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return  # platform without O_RDONLY dirs; rename is still atomic
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def makedirs_durable(path: str) -> None:
    """``os.makedirs`` whose result survives a HOST crash: every level
    that was actually created gets its parent directory fsynced.
    ``makedirs`` alone only survives process death — the new dirent
    lives in the parent's page cache until the parent is synced, so a
    power cut could erase the directory a checkpoint was just renamed
    into."""
    path = os.path.abspath(path)
    missing = []
    p = path
    while p and not os.path.isdir(p):
        missing.append(p)
        nxt = os.path.dirname(p)
        if nxt == p:
            break
        p = nxt
    os.makedirs(path, exist_ok=True)
    for created in reversed(missing):
        _fsync_dir(os.path.dirname(created))


def atomic_write_bytes(path: str, data: bytes) -> None:
    """Write ``data`` to ``path`` via tmp-file + fsync + rename: the
    file at ``path`` is always either the old content or all of
    ``data``, never a prefix."""
    d = os.path.dirname(os.path.abspath(path))
    makedirs_durable(d)
    # staging name unique per (process, thread, moment): concurrent
    # writers of the SAME path (racing manifest rewrites) must not
    # replace each other's staging file out from under the os.replace
    tmp = os.path.join(d, ".tmp-%s-%d-%d-%d" % (
        os.path.basename(path), os.getpid(),
        threading.get_ident() % 100000, time.monotonic_ns() % 1_000_000))
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    _fsync_dir(d)


def write_manifest(dirname: str, extra: Optional[Dict] = None,
                   files: Optional[List[str]] = None) -> Dict:
    """Hash files in ``dirname`` into ``__manifest__.json``, written
    atomically LAST — a dir with a valid manifest is a complete dir.
    ``files`` (names relative to ``dirname``) restricts the manifest
    to exactly what a save wrote; the default hashes every regular
    file (dedicated checkpoint dirs) — a save into a SHARED dir must
    pass ``files`` or it would pin unrelated, mutable files and make
    later verification fail spuriously."""
    names = files if files is not None else [
        fn for fn in sorted(os.listdir(dirname))
        if fn != MANIFEST_NAME and not fn.startswith(".tmp-")]
    listed = {}
    for fn in sorted(names):
        p = os.path.join(dirname, fn)
        if not os.path.isfile(p):
            continue
        _fsync_file(p)
        listed[fn] = {"sha256": _sha256(p),
                      "bytes": os.path.getsize(p)}
    doc = {"version": 1, "files": listed}
    if extra:
        doc.update(extra)
    atomic_write_bytes(os.path.join(dirname, MANIFEST_NAME),
                       json.dumps(doc, indent=1, sort_keys=True).encode())
    return doc


def manifest_extra(dirname: str) -> Dict:
    """The caller-supplied ``extra`` a save recorded in ``dirname``'s
    manifest — everything outside the reserved ``version``/``files``
    keys ({} when there is none, or the manifest is unreadable: the
    extra is advisory metadata, e.g. the PS shard map a trainer
    checkpoints so its relaunched incarnation resumes ROUTING from
    the checkpoint instead of rediscovering migrations through
    wrong_shard redirects; never load-bearing for the payload, which
    stays manifest-verified)."""
    try:
        with open(os.path.join(dirname, MANIFEST_NAME), "r",
                  encoding="utf-8") as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return {}
    return {k: v for k, v in doc.items()
            if k not in ("version", "files")}


def verify_manifest(dirname: str, required: bool = True) -> Optional[Dict]:
    """Recompute and check every file listed in ``dirname``'s manifest.
    Raises ``CheckpointCorrupt`` on any mismatch; with
    ``required=False`` a missing manifest returns None (pre-manifest
    dirs stay loadable), otherwise it is itself corruption — an atomic
    save always writes one."""
    mpath = os.path.join(dirname, MANIFEST_NAME)
    if not os.path.exists(mpath):
        if not required:
            return None
        raise CheckpointCorrupt(
            "checkpoint dir %r has no %s — it was not written by an "
            "atomic save (or the save never completed)"
            % (dirname, MANIFEST_NAME))
    try:
        with open(mpath, "r", encoding="utf-8") as f:
            doc = json.load(f)
        listed = doc["files"]
    except (ValueError, KeyError, OSError) as e:
        raise CheckpointCorrupt(
            "checkpoint manifest %r is unreadable: %s" % (mpath, e)
        ) from e
    for fn, meta in listed.items():
        p = os.path.join(dirname, fn)
        if not os.path.exists(p):
            raise CheckpointCorrupt(
                "checkpoint %r is missing file %r listed in its "
                "manifest" % (dirname, fn))
        size = os.path.getsize(p)
        if size != int(meta.get("bytes", -1)):
            raise CheckpointCorrupt(
                "checkpoint file %r is %d bytes, manifest says %s"
                % (p, size, meta.get("bytes")))
        digest = _sha256(p)
        if digest != meta.get("sha256"):
            raise CheckpointCorrupt(
                "checkpoint file %r fails sha256 verification "
                "(got %s…, manifest says %s…)"
                % (p, digest[:12], str(meta.get("sha256"))[:12]))
    return doc


def load_scope_snapshot(executor, scope, dirname: str) -> int:
    """Restore a scope snapshot directory (one tensor stream a var, a
    manifest) into ``scope`` after verifying its manifest: a server that
    rejoins must never boot off a torn snapshot, so any integrity failure
    raises the typed ``CheckpointCorrupt`` instead of loading garbage
    params. Var names come from ``__vars__.json`` when present and fall
    back to the file names. ``executor`` is anything with
    ``_write_var(scope, name, value)`` (the op-by-op ``CoreExecutor``);
    values land on its ``device`` (the host where it names none). Returns
    the number of vars restored."""
    from .core import proto_format
    from .core.tensor import from_host_array

    verify_manifest(dirname, required=True)
    vmap_path = os.path.join(dirname, SCOPE_VARS_NAME)
    if os.path.exists(vmap_path):
        with open(vmap_path, "r", encoding="utf-8") as f:
            names = json.load(f)
    else:
        names = {fn: fn for fn in sorted(os.listdir(dirname))
                 if fn not in (MANIFEST_NAME, SCOPE_VARS_NAME)
                 and not fn.startswith(".tmp-")
                 and os.path.isfile(os.path.join(dirname, fn))}
    loaded = 0
    for fn, var in sorted(names.items()):
        with open(os.path.join(dirname, fn), "rb") as f:
            data = f.read()
        arr, _lod, _pos = proto_format.parse_lod_tensor(data)
        executor._write_var(scope, var, from_host_array(
            arr, getattr(executor, "device", None)))
        loaded += 1
    return loaded


@contextlib.contextmanager
def atomic_checkpoint_dir(final_dir: str, extra: Optional[Dict] = None):
    """Context manager: yields a temp dir to write checkpoint files
    into; on clean exit fsyncs everything, writes the manifest, and
    renames the temp dir to ``final_dir`` (replacing any previous
    version only after the new one is durable). On error the temp dir
    is removed and ``final_dir`` is untouched."""
    final_dir = os.path.abspath(final_dir).rstrip(os.sep)
    parent = os.path.dirname(final_dir)
    makedirs_durable(parent)
    # sweep trash a SIGKILLed earlier save stranded (NOT .tmp- dirs: a
    # concurrent save of the same name may be live inside one; tmp
    # leftovers are invisible to scans and merely cost disk)
    base = os.path.basename(final_dir)
    for fn in os.listdir(parent):
        if fn.startswith(base + ".trash-"):
            shutil.rmtree(os.path.join(parent, fn), ignore_errors=True)
    tmp = "%s.tmp-%d-%d" % (final_dir, os.getpid(),
                            time.monotonic_ns() % 1_000_000)
    os.makedirs(tmp)
    t0 = time.monotonic()
    try:
        yield tmp
        doc = write_manifest(tmp, extra=extra)
        _fsync_dir(tmp)
        if os.path.isdir(final_dir):
            # rename-aside + rename-in, not rmtree-then-rename: the
            # no-checkpoint window shrinks to the instant between the
            # two renames (a SIGKILL exactly there costs only THIS
            # name — rotation siblings still serve load_latest; the
            # stranded trash/tmp dirs are swept by the next save)
            trash = "%s.trash-%d-%d" % (final_dir, os.getpid(),
                                        time.monotonic_ns() % 1_000_000)
            os.rename(final_dir, trash)
            os.rename(tmp, final_dir)
            shutil.rmtree(trash, ignore_errors=True)
        else:
            os.rename(tmp, final_dir)
        _fsync_dir(parent)
        total = sum(int(m["bytes"]) for m in doc["files"].values())
        _count("checkpoint.bytes", total)
        _observe("checkpoint.save_ms", (time.monotonic() - t0) * 1e3)
        _flight.record("checkpoint.commit",
                       dir=os.path.basename(final_dir), bytes=total,
                       ms=round((time.monotonic() - t0) * 1e3, 3))
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


class CheckpointManager:
    """Keep-last-k rotation under one root::

        root/
          ckpt-42/   __params__.npz  __manifest__.json
          ckpt-43/   ...
          latest     -> "ckpt-43"        (atomically updated pointer)

    ``save`` writes a new numbered checkpoint atomically, repoints
    ``latest``, and prunes beyond ``keep``. ``load_latest`` tries the
    pointer first, then remaining checkpoints newest-to-oldest,
    skipping (and counting) corrupt ones."""

    def __init__(self, root: str, keep: int = 3):
        self.root = os.path.abspath(root)
        self.keep = max(1, int(keep))

    # -- layout ------------------------------------------------------------

    def dir_for(self, step: int) -> str:
        return os.path.join(self.root, "%s%d" % (_CKPT_PREFIX, int(step)))

    def steps(self) -> List[int]:
        """Completed (renamed-into-place) checkpoint steps, ascending;
        temp/trash dirs are invisible by construction."""
        if not os.path.isdir(self.root):
            return []
        out = []
        for fn in os.listdir(self.root):
            if not fn.startswith(_CKPT_PREFIX):
                continue
            tail = fn[len(_CKPT_PREFIX):]
            if tail.isdigit() and os.path.isdir(
                    os.path.join(self.root, fn)):
                out.append(int(tail))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        """The ``latest`` pointer's step when it names an existing
        checkpoint, else the newest numbered dir, else None."""
        ptr = os.path.join(self.root, _LATEST_NAME)
        try:
            with open(ptr, "r", encoding="utf-8") as f:
                name = f.read().strip()
            tail = name[len(_CKPT_PREFIX):]
            if (name.startswith(_CKPT_PREFIX) and tail.isdigit()
                    and os.path.isdir(os.path.join(self.root, name))):
                return int(tail)
        except OSError:
            pass
        steps = self.steps()
        return steps[-1] if steps else None

    # -- save / load -------------------------------------------------------

    def save(self, step: int, writer: Callable[[str], None],
             extra: Optional[Dict] = None) -> str:
        """Write checkpoint ``step`` atomically: ``writer(tmp_dir)``
        produces the files; manifest + rename + ``latest`` update +
        pruning happen here. Returns the final dir."""
        final = self.dir_for(step)
        meta = {"step": int(step)}
        if extra:
            meta.update(extra)
        with atomic_checkpoint_dir(final, extra=meta) as tmp:
            writer(tmp)
        atomic_write_bytes(os.path.join(self.root, _LATEST_NAME),
                           os.path.basename(final).encode())
        self._prune()
        return final

    def save_incremental(self, step: int, shards: Dict,
                         fingerprints: Optional[Dict[str, str]] = None,
                         extra: Optional[Dict] = None,
                         reuse: str = "link") -> str:
        """Write checkpoint ``step`` reusing unchanged shards from the
        previous checkpoint. ``shards`` maps file name -> bytes or a
        zero-arg callable producing bytes (lazy: never called when the
        shard is fingerprint-matched). A shard is reused — hardlinked
        (``reuse="link"``, the cheap default) or copied
        (``reuse="copy"``) from the previous checkpoint dir — when

        - ``fingerprints[name]`` matches the fingerprint the previous
          manifest recorded for it (the caller's cheap dirty-tracking:
          a version counter, the server's replication digest, ...), or
        - its produced bytes' sha256 matches the previous manifest
          entry (content dedupe — still skips the fresh write+fsync).

        Every dir remains self-contained in its NAMESPACE (loaders and
        ``verify_manifest`` are oblivious), atomic, and rotated as
        usual. Hardlink caveat: reused shards share an inode with the
        previous checkpoint, so in-PLACE corruption of one damages
        both (both detected by their manifests); corruption that
        replaces the file (the common torn-write case) breaks the link
        and costs one checkpoint. Use ``reuse="copy"`` where that
        blast radius matters more than the write savings.

        ``checkpoint.delta_bytes`` counts only the freshly-written
        payload; ``checkpoint.shards_reused`` counts the links — the
        pair is the incremental win, next to the full
        ``checkpoint.bytes``."""
        if reuse not in ("link", "copy"):
            raise ValueError("reuse must be 'link' or 'copy', got %r"
                             % reuse)
        fingerprints = dict(fingerprints or {})
        prev_step = self.latest_step()
        prev_dir = self.dir_for(prev_step) if prev_step is not None \
            else None
        prev_files: Dict = {}
        prev_fps: Dict = {}
        if prev_dir is not None:
            try:
                with open(os.path.join(prev_dir, MANIFEST_NAME),
                          encoding="utf-8") as f:
                    doc = json.load(f)
                prev_files = doc.get("files", {}) or {}
                prev_fps = doc.get("fingerprints", {}) or {}
            except (OSError, ValueError):
                prev_files, prev_fps = {}, {}  # unreadable: full save

        stats = {"reused": 0, "fresh_bytes": 0}

        def _reuse(src: str, dst: str) -> None:
            if reuse == "link":
                try:
                    os.link(src, dst)
                    return
                except OSError:
                    pass  # cross-device / fs without links: fall back
            shutil.copy2(src, dst)

        def writer(tmp: str) -> None:
            for fn in sorted(shards):
                prev_meta = prev_files.get(fn)
                prev_path = (os.path.join(prev_dir, fn)
                             if prev_dir is not None else None)
                have_prev = (prev_meta is not None and prev_path
                             and os.path.isfile(prev_path))
                fp = fingerprints.get(fn)
                if (have_prev and fp is not None
                        and prev_fps.get(fn) == fp):
                    _reuse(prev_path, os.path.join(tmp, fn))
                    stats["reused"] += 1
                    continue
                src = shards[fn]
                data = src() if callable(src) else bytes(src)
                if (have_prev and prev_meta.get("sha256")
                        == hashlib.sha256(data).hexdigest()):
                    _reuse(prev_path, os.path.join(tmp, fn))
                    stats["reused"] += 1
                    continue
                atomic_write_bytes(os.path.join(tmp, fn), data)
                stats["fresh_bytes"] += len(data)

        meta = dict(extra or {})
        meta["fingerprints"] = fingerprints
        final = self.save(step, writer, extra=meta)
        _count("checkpoint.delta_bytes", stats["fresh_bytes"])
        _count("checkpoint.shards_reused", stats["reused"])
        return final

    def _prune(self) -> None:
        steps = self.steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(self.dir_for(s), ignore_errors=True)

    def load_latest(self, loader: Callable[[str], None]) -> Optional[int]:
        """Verify + load the newest valid checkpoint; walks past
        corrupt ones (counting ``checkpoint.corrupt``) so one bad
        shard falls back to the previous rotation. Returns the loaded
        step, or None when no checkpoint exists. Raises
        ``CheckpointCorrupt`` only when checkpoints exist but ALL fail
        verification."""
        candidates = sorted(self.steps(), reverse=True)
        latest = self.latest_step()
        if latest is not None and latest in candidates:
            candidates.remove(latest)
            candidates.insert(0, latest)
        if not candidates:
            return None
        errors = []
        for step in candidates:
            d = self.dir_for(step)
            try:
                verify_manifest(d, required=True)
                loader(d)
                return step
            except CheckpointCorrupt as e:
                _count("checkpoint.corrupt")
                errors.append(str(e))
                continue
        raise CheckpointCorrupt(
            "every checkpoint under %r failed verification: %s"
            % (self.root, "; ".join(errors)))

    def load_at_or_before(self, step: int,
                          loader: Callable[[str], None]) -> Optional[int]:
        """Like ``load_latest`` but clamped to checkpoints at or below
        ``step`` — the whole-job cold-restart case: the
        launcher's common restore cut can sit BEHIND this process's
        newest checkpoint (a sister shard's newest round was torn and
        the job fell back one round), and resuming ahead of the
        servers would re-drive nothing while the servers wait for
        rounds the trainer thinks already happened. Walks the eligible
        checkpoints newest-to-oldest past corrupt ones; returns the
        loaded step or None when none qualify."""
        step = int(step)
        candidates = [s for s in sorted(self.steps(), reverse=True)
                      if s <= step]
        if not candidates:
            return None
        errors = []
        for s in candidates:
            d = self.dir_for(s)
            try:
                verify_manifest(d, required=True)
                loader(d)
                return s
            except CheckpointCorrupt as e:
                _count("checkpoint.corrupt")
                errors.append(str(e))
                continue
        raise CheckpointCorrupt(
            "every checkpoint at or before step %d under %r failed "
            "verification: %s" % (step, self.root, "; ".join(errors)))


def save_checkpoint(executor, root: str, step: int, main_program=None,
                    keep: int = 3) -> str:
    """Atomic rotated persistables checkpoint for a static-graph
    program: ``io.save_persistables`` into ``root/ckpt-<step>/`` with
    manifest + ``latest`` pointer; keeps the newest ``keep``."""
    from . import io as _io

    mgr = CheckpointManager(root, keep=keep)
    return mgr.save(step, lambda d: _io.save_persistables(
        executor, d, main_program))


def load_checkpoint(executor, root: str, main_program=None):
    """Load the newest valid checkpoint saved by ``save_checkpoint``;
    returns its step, or None when ``root`` holds none."""
    from . import io as _io

    mgr = CheckpointManager(root)
    return mgr.load_latest(lambda d: _io.load_persistables(
        executor, d, main_program))
