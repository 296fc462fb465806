"""A partition's data: in-memory parts, then small and big file parts.

The JAX package's datadb without its threads.  Every batch added is an
in-memory part that queries see at once.  A flush merges the waiting
batches (storage/merge.py) into one part: with a directory, a small
file part written by `write_part` and listed in the `parts.json`
manifest; without one (a memory-only store), an in-memory part.  An add
flushes once more than `max_inmemory_parts` batches wait (the
MAX_INMEMORY_PARTS of the store), or, with a directory, once the oldest
waiting batch is `flush_interval` seconds old, checked at the add in
place of the JAX flusher thread; `close()` flushes too.

With a directory, a flush that leaves DEFAULT_PARTS_TO_MERGE small (or
big) parts merges the tier at once: a streaming k-way merge that reads
each part a block at a time, written as one part (big when its
compressed size reaches BIG_PART_SIZE, or always for the big tier),
unless the disk cannot hold 1.2 times the inputs plus 64 MiB.  The
manifest is written to a `.tmp` name, fsynced, renamed and its
directory fsynced; the parts a merge replaced are closed and removed
after that.  On open, part directories the manifest does not list and
`.tmp` leftovers are removed.  A memory-only store never merges a tier.
"""

from __future__ import annotations

import json
import os
import shutil
import time

from .merge import merge_block_streams
from .part import FilePart, Part, fsync_dir, write_part

DEFAULT_PARTS_TO_MERGE = 15
MAX_INMEMORY_PARTS = 8
BIG_PART_SIZE = 64 << 20             # compressed bytes: small -> big
PARTS_JSON = "parts.json"


class DataDB:
    def __init__(self, path: str | None = None, flush_interval: float = 5.0,
                 max_inmemory_parts: int = MAX_INMEMORY_PARTS):
        self.path = path
        self.flush_interval = flush_interval
        self.max_inmemory_parts = max_inmemory_parts
        self.inmemory_parts: list[Part] = []
        self._oldest_at = 0.0            # when the oldest waiting batch came
        self.small_parts: list = []
        self.big_parts: list = []
        self._next_part_id = 0
        self.merges_done = 0
        # the filter index figures of each part this datadb sealed, in
        # order ({"merge": bool, "rows", "blocks", "filter_index"})
        self.seals: list = []
        if path is not None:
            os.makedirs(path, exist_ok=True)
            self._open_existing()

    def _sealed(self, meta: dict, merge: bool = False) -> None:
        self.seals.append({"merge": merge, "rows": meta["rows"],
                           "blocks": meta["blocks"],
                           "filter_index": meta.get("filter_index")})

    # ---- open ----

    def _open_existing(self) -> None:
        manifest = os.path.join(self.path, PARTS_JSON)
        names: list[str] = []
        if os.path.exists(manifest):
            with open(manifest) as f:
                names = json.load(f)["parts"]
        referenced = set(names)
        for entry in os.listdir(self.path):
            full = os.path.join(self.path, entry)
            if entry == PARTS_JSON:
                continue
            if os.path.isdir(full):
                if entry not in referenced:
                    # a crash during a write or merge left it
                    shutil.rmtree(full)
            elif entry.endswith(".tmp"):
                os.remove(full)
        for name in names:
            p = FilePart(os.path.join(self.path, name))
            self._tier(p).append(p)
            try:
                self._next_part_id = max(self._next_part_id,
                                         int(name.split("_")[-1], 16) + 1)
            except ValueError:
                pass

    def _tier(self, p, big: bool = False) -> list:
        return self.big_parts if big or \
            p.meta["compressed_size"] >= BIG_PART_SIZE else self.small_parts

    def _write_manifest(self) -> None:
        names = [p.name for p in self.small_parts + self.big_parts]
        tmp = os.path.join(self.path, PARTS_JSON + ".tmp")
        with open(tmp, "w") as f:
            json.dump({"parts": names}, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, os.path.join(self.path, PARTS_JSON))
        fsync_dir(self.path)

    def _new_part_path(self) -> str:
        name = f"part_{self._next_part_id:016x}"
        self._next_part_id += 1
        return os.path.join(self.path, name)

    # ---- the write path ----

    def must_add_blocks(self, blocks: list) -> None:
        """Add one batch's blocks as an in-memory part, then flush when
        too many batches wait or (with a directory) the oldest is
        flush_interval seconds old."""
        if not blocks:
            return
        now = time.monotonic()
        if not self.inmemory_parts:
            self._oldest_at = now
        self.inmemory_parts.append(Part(blocks))
        if len(self.inmemory_parts) > self.max_inmemory_parts or (
                self.path is not None
                and now - self._oldest_at >= self.flush_interval):
            self.flush_inmemory_parts()

    def flush_inmemory_parts(self) -> None:
        """The waiting batches as one part.  They stay listed until the
        part that replaces them is, so their rows stay visible, and stay
        waiting when the write fails."""
        imps = self.inmemory_parts
        if not imps:
            return
        if len(imps) == 1:
            blocks = imps[0].blocks
        else:
            blocks = merge_block_streams([im.blocks for im in imps])
        if self.path is None:
            # a lone batch's part becomes the flushed part as it is
            self.small_parts.append(imps[0] if len(imps) == 1
                                    else Part(list(blocks)))
            self.inmemory_parts = []
            return
        out = self._new_part_path()
        try:
            self._sealed(write_part(out, blocks))
        except BaseException:
            shutil.rmtree(out + ".tmp", ignore_errors=True)
            raise
        self.small_parts.append(FilePart(out))
        self.inmemory_parts = []
        self._write_manifest()
        self._maybe_merge()

    def _maybe_merge(self) -> None:
        """Merge a tier that holds DEFAULT_PARTS_TO_MERGE parts or more,
        until none does or the disk has no room for a merge."""
        while True:
            if len(self.small_parts) >= DEFAULT_PARTS_TO_MERGE:
                to_merge, big = list(self.small_parts), False
            elif len(self.big_parts) >= DEFAULT_PARTS_TO_MERGE:
                to_merge, big = list(self.big_parts), True
            else:
                return
            if not self._merge_parts(to_merge, big):
                return

    def force_merge(self) -> None:
        """Flush, then merge every part into one (a big part)."""
        self.flush_inmemory_parts()
        to_merge = self.small_parts + self.big_parts
        if len(to_merge) <= 1:
            return
        if self.path is None:
            self.small_parts = [Part(list(merge_block_streams(
                [p.blocks for p in to_merge])))]
            self.big_parts = []
            return
        self._merge_parts(to_merge, big=True)

    def _merge_parts(self, to_merge: list, big: bool) -> bool:
        """Merge `to_merge` into one part; False (nothing done) when the
        disk cannot hold the output."""
        need = int(sum(p.meta["compressed_size"] for p in to_merge)
                   * 1.2) + (64 << 20)
        if shutil.disk_usage(self.path).free < need:
            return False
        out = self._new_part_path()
        try:
            self._sealed(write_part(out, merge_block_streams(
                [p.iter_blocks() for p in to_merge]), big=big), merge=True)
        except BaseException:
            shutil.rmtree(out + ".tmp", ignore_errors=True)
            raise
        newp = FilePart(out)
        gone = set(id(p) for p in to_merge)
        self.small_parts = [p for p in self.small_parts if id(p) not in gone]
        self.big_parts = [p for p in self.big_parts if id(p) not in gone]
        self._tier(newp, big).append(newp)
        self._write_manifest()
        self.merges_done += 1
        for p in to_merge:
            p.close()
            shutil.rmtree(p.path)
        fsync_dir(self.path)
        return True

    # ---- the read path ----

    def snapshot_parts(self) -> list:
        """The parts a query walks: the waiting batches, oldest first,
        then the small and the big parts."""
        return self.inmemory_parts + self.small_parts + self.big_parts

    def stats(self) -> dict:
        files = self.small_parts + self.big_parts
        durable = self.path is not None
        return {
            "inmemory_parts": len(self.inmemory_parts),
            "small_parts": len(self.small_parts),
            "big_parts": len(self.big_parts),
            "inmemory_rows": sum(p.num_rows for p in self.inmemory_parts),
            "file_rows": sum(p.num_rows for p in files),
            "small_rows": sum(p.num_rows for p in self.small_parts),
            "big_rows": sum(p.num_rows for p in self.big_parts),
            "compressed_size": sum(p.meta["compressed_size"]
                                   for p in files) if durable else 0,
            "uncompressed_size": sum(p.meta["uncompressed_size"]
                                     for p in files) if durable else 0,
            "pending_merges":
                int(len(self.small_parts) >= DEFAULT_PARTS_TO_MERGE)
                + int(len(self.big_parts) >= DEFAULT_PARTS_TO_MERGE),
            "merges_done": self.merges_done,
            "flush_age_seconds": time.monotonic() - self._oldest_at
            if self.inmemory_parts else 0.0,
        }

    def close(self) -> None:
        """Flush (with a directory) and close the file parts."""
        if self.path is not None:
            self.flush_inmemory_parts()
        for p in self.small_parts + self.big_parts:
            p.close()
