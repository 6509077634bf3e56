"""High-level seed-extend long-read aligner.

Drop-in replacement for every external aligner invocation in the reference
driver (/root/reference/AlignGraph2.py:232-296,306-355,478-485):

  * reads -> contigs        (mecat2ref)
  * reads -> similar genome (mecat2ref+ with alpha/beta/delta)
  * contigs -> genome       (long2ref chunking, replacing the nucmer path)
  * reads -> new backbones  (consensus prep)

One code path: build a SeedIndex over the target database, find candidate
(target, strand, diagonal) triples per query, extend each with the
static-band extension (ops/extend.py; reads past MAX_STATIC_NQ and the
mesh path use the adaptive band of ops/banded_dp.py), and emit 3-line
".ref"-compatible alignment records.
"""

from __future__ import annotations

import logging
from typing import List, Sequence

import numpy as np

logger = logging.getLogger("aligngraph2_tpu.align")

from ..config import AlignerConfig
from ..io.seqdb import SeqDatabase, revcomp_codes
from ..ops.banded_dp import (banded_align, moves_to_strings, scan_lanes,
                             traceback)
from ..ops.kmer import kmer_codes_np
from ..ops.seedextend import Candidate, SeedIndex, find_candidates
from .records import Alignment, AlignmentSet


# longest length bucket the static-band extension takes; reads past it
# keep the adaptive band of ops/banded_dp.py, which follows indel drift
MAX_STATIC_NQ = 65536


def _bucket(n: int, lo: int = 512) -> int:
    """Length bucket for batch shapes.  Coarse on purpose: every
    distinct bucket compiles its own traceback walk.  The
    10240/12288/16384 rungs keep PacBio-length reads (~9 kb mean) from
    padding to 32768."""
    for b in (512, 2048, 8192, 10240, 12288, 16384, 32768):
        if n <= b:
            return b
    b = 32768
    while b < n:
        b <<= 1
    return b


class LongReadAligner:
    """Seed-extend aligner.  Single device: host seeding + static-band
    extension (ops/extend.py).  With ``mesh``: block-sharded device
    seeding + all-device extension (parallel/sharded.py)."""

    def __init__(self, target_db: SeqDatabase, cfg: AlignerConfig,
                 progress: bool = False,
                 mesh=None, checkpoint_path: str | None = None,
                 checkpoint_flush_s: float = 300.0):
        self.db = target_db
        # auto-scale seed k with target size (flat noise-hit rate; see
        # ops/seedextend.effective_seed_k) — both the host and sharded
        # seeding paths read the updated cfg, so mesh and single-device
        # runs stay bit-identical
        from ..ops.seedextend import effective_seed_k
        k_eff = effective_seed_k(cfg, target_db)
        if k_eff != cfg.seed_k:
            import dataclasses
            logger.info("seed_k auto-scaled %d -> %d for a %.1f Mb "
                        "target", cfg.seed_k, k_eff,
                        target_db.lengths.sum() / 1e6)
            cfg = dataclasses.replace(cfg, seed_k=k_eff)
        self.cfg = cfg
        self.mesh = mesh
        self.checkpoint_path = checkpoint_path
        self.checkpoint_flush_s = checkpoint_flush_s
        if mesh is None:
            self.index = SeedIndex(target_db, cfg.seed_k,
                                   stride=cfg.seed_stride)
        else:
            self._block_index = None   # built lazily on first align
            self._dev_index = None
            self._seeders = {}
            self._extenders = {}
        self.progress = progress

    # ---------------- candidate generation ----------------

    def _read_candidates(self, codes_f: np.ndarray) -> List[Candidate]:
        cfg = self.cfg
        codes_r = revcomp_codes(codes_f)
        qk_f = kmer_codes_np(codes_f, cfg.seed_k)
        qk_r = kmer_codes_np(codes_r, cfg.seed_k)
        return find_candidates(
            self.index, qk_f, qk_r, bin_w=max(cfg.band_width // 2, 32),
            max_candidates=cfg.max_candidates,
            min_hits=cfg.min_block_hits, alpha=cfg.alpha, beta=cfg.beta,
            prune=cfg.prune_ratio)

    # ---------------- checkpointing ----------------

    def _make_checkpoint(self, read_db, ids, kind: str,
                         out: AlignmentSet, best_per_read) -> tuple:
        """(checkpoint, resume cursor): intra-stage resume for long
        alignment stages (SURVEY.md §5; align/checkpoint.py).  Preloads
        already-emitted alignments into the running set so the duplicate
        filter and per-read best table see the same history as an
        uninterrupted run."""
        if not self.checkpoint_path:
            return None, 0
        from .checkpoint import AlignCheckpoint, stage_token
        token = stage_token(self.cfg, self.db, read_db,
                            list(ids) if ids is not None else None) \
            + "/" + kind
        ck = AlignCheckpoint(self.checkpoint_path, token,
                             self.checkpoint_flush_s)
        cursor, pre = ck.resume()
        for a in pre:
            out.append(a)
            if a.score > best_per_read.get(a.query_name, 0):
                best_per_read[a.query_name] = a.score
        return ck, cursor

    # ---------------- extension ----------------

    def align_reads(self, read_db: SeqDatabase,
                    ids: Sequence[int] | None = None) -> AlignmentSet:
        cfg = self.cfg
        W = cfg.band_width
        if ids is None:
            ids = range(len(read_db))
        # ultra-long outliers would explode the padded DP stream; skip them
        ids = list(ids)
        n_before = len(ids)
        ids = [r for r in ids if read_db.size(r) <= cfg.max_read_len]
        self.n_skipped_long = n_before - len(ids)
        if self.n_skipped_long:
            logger.warning(
                "skipping %d read(s) longer than max_read_len=%d "
                "(raise AlignerConfig.max_read_len to align them)",
                self.n_skipped_long, cfg.max_read_len)
        if self.mesh is not None:
            return self._align_reads_sharded(read_db, ids)

        # phase 1: batched seeding (host, one searchsorted per chunk)
        from ..ops.seedextend import find_candidates_batch
        cand_map = find_candidates_batch(
            self.index, read_db, list(ids),
            bin_w=max(cfg.band_width // 2, 32),
            max_candidates=cfg.max_candidates,
            min_hits=cfg.min_block_hits, alpha=cfg.alpha, beta=cfg.beta,
            prune=cfg.prune_ratio)
        jobs = []  # (rid, cand, codes_aligned_strand)
        for rid, cands in cand_map.items():
            if not cands:
                continue
            codes_f = read_db.get_codes(rid)
            for cand in cands:
                codes = codes_f if cand.forward else revcomp_codes(codes_f)
                jobs.append((rid, cand, codes))

        # phase 2: banded extension, batched by length bucket.  The
        # static-band batches are software-pipelined: while the device
        # runs batch i, the host prepares batch i+1 (padding, window
        # gather) and only then drains batch i's traceback expansion +
        # emission — host work and device work overlap instead of
        # strictly alternating (SURVEY.md §2.6 pipeline row).
        jobs.sort(key=lambda j: len(j[2]))
        out = AlignmentSet()
        best_per_read: dict[int, int] = {}
        ck, cursor = self._make_checkpoint(read_db, ids, "single", out,
                                           best_per_read)
        watermark = len(out)
        from ..utils.timing import Progress
        bar = Progress(len(jobs), enabled=self.progress)
        batches = []
        i = min(cursor, len(jobs))
        bar.update(i)
        while i < len(jobs):
            NQ = _bucket(len(jobs[i][2]))
            static = NQ <= MAX_STATIC_NQ
            B = self._batch_size(NQ, static)
            batch = []
            while i < len(jobs) and len(batch) < B \
                    and _bucket(len(jobs[i][2])) == NQ:
                batch.append(jobs[i])
                i += 1
            batches.append((NQ, static, batch, i))

        def mark(consumed: int) -> None:
            nonlocal watermark
            if ck is not None and ck.should_flush():
                ck.flush(out.alignments[watermark:], consumed)
                watermark = len(out)

        def finish(pending) -> None:
            """Drain one in-flight static-band batch."""
            handles, prep, end_i = pending
            self._finish_static(read_db, handles, prep, out, best_per_read)
            bar.update(len(prep[0]))
            mark(end_i)

        pending = None  # (handles, prep, cursor) of the in-flight batch
        for NQ, static, batch, end_i in batches:
            if static:
                prep = self._prep_static(batch, NQ)
                handles = self._dispatch_static(prep)
                if pending is not None:
                    finish(pending)
                pending = (handles, prep, end_i)
            else:
                if pending is not None:
                    finish(pending)
                    pending = None
                self._extend_batch(read_db, batch, NQ, NQ + 2 * W, out,
                                   best_per_read)
                bar.update(len(batch))
                mark(end_i)
        if pending is not None:
            finish(pending)
        if ck is not None:
            ck.close()

        # delta filter: drop alignments scoring < delta * read best
        # (recovered mecat2ref+ '-y delta' semantics, see seedextend.py)
        kept = [a for a in out
                if a.score >= cfg.delta * best_per_read.get(
                    a.query_name, a.score)]
        n_dup = getattr(self, "n_dedup_suppressed", 0)
        if n_dup:
            logger.info("suppressed %d duplicate alignment(s) "
                        "(last-%d-record window)", n_dup, 8)
        res = AlignmentSet(kept)
        res.sort_by_score()
        return res

    @property
    def _static_W(self) -> int:
        return max(self.cfg.band_width, 256)

    def _batch_size(self, NQ: int, static: bool) -> int:
        if static:
            from ..ops.extend import max_lanes
            return max_lanes(NQ, self._static_W)
        W = self.cfg.band_width
        return scan_lanes(NQ, NQ + 2 * W, W)

    def _emit(self, read_db, rid, cand, codes, score, qstr, tstr,
              qb, qe, rb, re, out: AlignmentSet, best_per_read) -> None:
        cfg = self.cfg
        if qe - qb < cfg.min_aln_len:
            return
        qa = np.frombuffer(qstr.encode(), np.uint8)
        ta = np.frombuffer(tstr.encode(), np.uint8)
        matches = int(np.count_nonzero(qa == ta))
        if matches < cfg.min_identity * len(qstr):
            return
        n = len(codes)
        if cand.forward:
            qb_f, qe_f = qb, qe
        else:
            qb_f, qe_f = n - qe, n - qb
        a = Alignment(
            query_name=read_db.names[rid],
            ref_name=self.db.names[cand.tid],
            forward=cand.forward, score=score,
            qb=qb_f, qe=qe_f, qsize=n,
            rb=rb, re=re, rsize=self.db.size(cand.tid),
            qstr=qstr, tstr=tstr)
        if self._is_duplicate(out, a):
            self.n_dedup_suppressed = getattr(
                self, "n_dedup_suppressed", 0) + 1
            return
        out.append(a)
        if score > best_per_read.get(a.query_name, 0):
            best_per_read[a.query_name] = score

    def _prep_static(self, batch, NQ):
        """Host stage: pad queries and gather standard-frame windows."""
        from ..ops.extend import (Q_SENTINEL, padded_lanes,
                                  standard_frame_windows)
        W = self._static_W
        B = padded_lanes(len(batch), self._batch_size(NQ, True))
        q = np.full((B, NQ), Q_SENTINEL, np.uint8)
        qlen = np.zeros(B, np.int32)
        t_codes = []
        diags = []
        for b, (rid, cand, codes) in enumerate(batch):
            q[b, :len(codes)] = codes
            qlen[b] = len(codes)
            t_codes.append(self.db.get_codes(cand.tid))
            diags.append(cand.diag)
        t_codes += [np.zeros(0, np.uint8)] * (B - len(batch))
        diags += [0] * (B - len(batch))
        t, starts = standard_frame_windows(t_codes, diags, NQ, W)
        return batch, NQ, W, q, qlen, t, starts

    def _dispatch_static(self, prep):
        """Device stage (async): DP + packed traceback walk.  Returns
        device handles only — no host sync happens here, so the caller
        can prepare the next batch while the device works."""
        from ..ops.extend import extend, traceback_packed_device
        batch, NQ, W, q, qlen, t, starts = prep
        cfg = self.cfg
        res = extend(q, t, qlen, W=W, match=cfg.match_score,
                     mismatch=cfg.mismatch_score, gap=cfg.gap_score,
                     x_drop=cfg.x_drop)
        # the packed walk equals traceback_t move for move but takes a
        # whole DIAG run per gather of a 16-row direction word
        runs, mvs, it = traceback_packed_device(
            res.words, res.best_i, res.best_j, max_steps=2 * NQ + W)
        return res.score, res.best_i, res.best_j, runs, mvs, it

    def _finish_static(self, read_db: SeqDatabase, handles, prep,
                       out: AlignmentSet, best_per_read) -> None:
        """Host stage: sync (two combined transfers), expand the packed
        moves (native core), emit records."""
        from ..ops.extend import expand_moves, fetch_packed_traceback
        batch, NQ, W, q, qlen, t, starts = prep
        score_d, best_i_d, best_j_d, runs, mvs, it = handles
        rows, runs_h, mvs_h, C = fetch_packed_traceback(
            runs, mvs, it, score_d, best_i_d, best_j_d,
            max_steps=2 * NQ + W)
        scores = rows[0]
        moves, nmoves, si, sj = expand_moves(
            runs_h, mvs_h, C, rows[1], rows[2], max_steps=2 * NQ + W)
        for b, (rid, cand, codes) in enumerate(batch):
            score = int(scores[b])
            if score <= 0:
                continue
            qb = int(si[b])
            tb = int(si[b] + sj[b])   # standard frame: p = i + j
            win = np.minimum(t[b], 3)  # sentinel-safe decode
            qstr, tstr, qe, te = moves_to_strings(moves[b], codes, qb, tb,
                                                  win)
            rb = int(starts[b] + tb)
            re = int(starts[b] + te)
            if rb < 0 or re > self.db.size(cand.tid):
                continue  # degenerate path through sentinel padding
            self._emit(read_db, rid, cand, codes, score, qstr, tstr,
                       qb, qe, rb, re, out, best_per_read)

    def _extend_batch(self, read_db: SeqDatabase, batch, NQ, NT,
                      out: AlignmentSet, best_per_read) -> None:
        cfg = self.cfg
        W = cfg.band_width
        # fixed batch shape per bucket: pad with inert jobs so jit compiles
        # once per (B, NQ) bucket instead of once per ragged batch
        B = self._batch_size(NQ, False)
        q = np.zeros((B, NQ), np.uint8)
        t = np.zeros((B, NT), np.uint8)
        qlen = np.zeros(B, np.int32)
        tlen = np.zeros(B, np.int32)
        c0 = np.zeros(B, np.int32)
        ws_arr = np.zeros(B, np.int64)
        for b, (rid, cand, codes) in enumerate(batch):
            n = len(codes)
            q[b, :n] = codes
            qlen[b] = n
            tcodes = self.db.get_codes(cand.tid)
            ws = max(0, cand.diag - W)
            win = tcodes[ws:ws + NT]
            t[b, :len(win)] = win
            tlen[b] = len(win)
            c0[b] = cand.diag - ws
            ws_arr[b] = ws

        res = banded_align(q, qlen, t, tlen, c0, W=W,
                           match=cfg.match_score,
                           mismatch=cfg.mismatch_score, gap=cfg.gap_score,
                           x_drop=cfg.x_drop)
        moves, nmoves, si, sj = traceback(res.dirs, res.centers,
                                          res.best_i, res.best_j,
                                          max_steps=NQ + NT)
        moves = np.asarray(moves)
        centers = np.asarray(res.centers)
        scores = np.asarray(res.score)
        si = np.asarray(si)
        sj = np.asarray(sj)

        for b, (rid, cand, codes) in enumerate(batch):
            score = int(scores[b])
            if score <= 0:
                continue
            qb = int(si[b])
            tb = int(si[b] + centers[b][si[b]] - W // 2 + sj[b])
            tcodes = self.db.get_codes(cand.tid)
            win = tcodes[ws_arr[b]:ws_arr[b] + NT]
            qstr, tstr, qe, te = moves_to_strings(moves[b], codes, qb, tb,
                                                  win)
            rb = int(ws_arr[b] + tb)
            re = int(ws_arr[b] + te)
            self._emit(read_db, rid, cand, codes, score, qstr, tstr,
                       qb, qe, rb, re, out, best_per_read)

    # ---------------- sharded (multi-device) path ----------------

    def _ensure_sharded_index(self) -> None:
        from ..parallel.sharded import build_block_index, put_sharded_index
        if self._block_index is not None:
            return
        cfg = self.cfg
        longest = int(self.db.lengths.max()) if len(self.db) else 1
        BL = min(cfg.block_size, longest)
        BL = max((BL + 127) // 128 * 128, 4 * cfg.band_width, 256)
        block_par = self.mesh.shape[self._block_axis]
        self._block_index = build_block_index(
            self.db, cfg.seed_k, BL, pad_blocks_to=block_par)
        self._dev_index = put_sharded_index(self._block_index, self.mesh,
                                            self._block_axis)

    @property
    def _data_axis(self) -> str:
        return self.mesh.axis_names[0]

    @property
    def _block_axis(self) -> str:
        return self.mesh.axis_names[1]

    def _get_seeder(self, NQ: int):
        if NQ not in self._seeders:
            from ..parallel.sharded import make_sharded_seeder
            cfg = self.cfg
            self._seeders[NQ] = make_sharded_seeder(
                self.mesh, k=cfg.seed_k, BL=self._block_index.block_len,
                bin_w=max(cfg.band_width // 2, 32),
                min_hits=cfg.min_block_hits, alpha=cfg.alpha,
                beta=cfg.beta, K=cfg.max_candidates,
                prune=cfg.prune_ratio,
                data_axis=self._data_axis, block_axis=self._block_axis)
        return self._seeders[NQ]

    def _get_extender(self, NQ: int, NT: int):
        if NQ not in self._extenders:
            from ..parallel.sharded import make_sharded_extender
            cfg = self.cfg
            self._extenders[NQ] = make_sharded_extender(
                self.mesh, W=cfg.band_width, match=cfg.match_score,
                mismatch=cfg.mismatch_score, gap=cfg.gap_score,
                x_drop=cfg.x_drop, max_steps=NQ + NT,
                data_axis=self._data_axis, block_axis=self._block_axis)
        return self._extenders[NQ]

    def _align_reads_sharded(self, read_db: SeqDatabase,
                             ids: Sequence[int]) -> AlignmentSet:
        """Mesh path of align_reads: device seeding over the block-sharded
        index, host lane compaction, all-device banded extension.  Output
        is bit-identical for any mesh shape (tests/test_sharded_aligner)."""
        import jax
        from jax.sharding import NamedSharding, PartitionSpec as P
        cfg = self.cfg
        mesh = self.mesh
        W = cfg.band_width
        K = cfg.max_candidates
        self._ensure_sharded_index()
        idx = self._block_index
        data_par = mesh.shape[self._data_axis]
        n_dev = int(np.prod(list(mesh.shape.values())))
        d_spec = NamedSharding(mesh, P(self._data_axis, None))
        d_spec1 = NamedSharding(mesh, P(self._data_axis))
        lanes_ax = (self._data_axis, self._block_axis)
        l_spec = NamedSharding(mesh, P(lanes_ax, None))
        l_spec1 = NamedSharding(mesh, P(lanes_ax))

        buckets: dict[int, list[int]] = {}
        for rid in ids:
            buckets.setdefault(_bucket(read_db.size(rid)), []).append(rid)

        out = AlignmentSet()
        best_per_read: dict[str, int] = {}
        # chunk partitioning depends on the mesh shape, so the resume
        # token must too (a resume on a different mesh restarts cleanly)
        mesh_kind = "mesh" + "x".join(str(int(s))
                                      for s in mesh.shape.values())
        ck, ck_cursor = self._make_checkpoint(read_db, ids, mesh_kind, out,
                                              best_per_read)
        watermark = len(out)
        consumed = 0   # reads consumed, in deterministic bucket order
        from ..utils.timing import Progress
        bar = Progress(len(ids), enabled=self.progress)
        for NQ in sorted(buckets):
            NT = NQ + 2 * W
            per_dev = scan_lanes(NQ, NT, W, mesh.devices.flat[0])
            B = data_par * per_dev
            lane_B = n_dev * per_dev
            seeder = self._get_seeder(NQ)
            extender = self._get_extender(NQ, NT)
            idsb = buckets[NQ]
            for s in range(0, len(idsb), B):
                chunk = idsb[s:s + B]
                if consumed + len(chunk) <= ck_cursor:
                    consumed += len(chunk)   # resumed past this chunk
                    bar.update(len(chunk))
                    continue
                rows = chunk + [-1] * (B - len(chunk))
                q_fwd = np.zeros((B, NQ), np.uint8)
                q_rev = np.zeros((B, NQ), np.uint8)
                lens = np.zeros(B, np.int32)
                for r, rid in enumerate(rows):
                    if rid < 0:
                        continue
                    cf = read_db.get_codes(rid)
                    q_fwd[r, :len(cf)] = cf
                    q_rev[r, :len(cf)] = revcomp_codes(cf)
                    lens[r] = len(cf)
                sel, c_block, c_strand, c_diag, c_cnt, c_score = seeder(
                    jax.device_put(q_fwd, d_spec),
                    jax.device_put(q_rev, d_spec),
                    jax.device_put(lens, d_spec1), *self._dev_index)
                sel = np.asarray(sel)
                c_block = np.asarray(c_block)
                c_strand = np.asarray(c_strand)
                c_diag = np.asarray(c_diag)
                c_cnt = np.asarray(c_cnt)
                c_score = np.asarray(c_score)

                # host lane compaction: live (read, candidate) pairs only
                lanes = []  # (row, k, tid, bstart, ws, tlen, c0)
                for r, rid in enumerate(rows):
                    if rid < 0:
                        continue
                    for kk in range(K):
                        if not sel[r, kk]:
                            continue
                        blk = int(c_block[r, kk])
                        diag = int(c_diag[r, kk])
                        tid = int(idx.block_seq[blk])
                        bstart = int(idx.block_start[blk])
                        ws = max(0, diag - W)
                        tlen = min(self.db.size(tid) - (bstart + ws), NT)
                        if tlen <= 0:
                            continue
                        lanes.append((r, kk, tid, bstart, ws, tlen,
                                      diag - ws))
                for ls in range(0, len(lanes), lane_B):
                    lchunk = lanes[ls:ls + lane_B]
                    LB = lane_B
                    q = np.zeros((LB, NQ), np.uint8)
                    qlen = np.zeros(LB, np.int32)
                    t = np.zeros((LB, NT), np.uint8)
                    tl = np.zeros(LB, np.int32)
                    c0 = np.zeros(LB, np.int32)
                    for li, (r, kk, tid, bstart, ws, tlen, c0v) \
                            in enumerate(lchunk):
                        q[li] = q_fwd[r] if c_strand[r, kk] else q_rev[r]
                        qlen[li] = lens[r]
                        win = self.db.get_codes(tid)[
                            bstart + ws:bstart + ws + NT]
                        t[li, :len(win)] = win
                        tl[li] = len(win)
                        c0[li] = c0v
                    e_score, e_moves, e_si, e_tb = extender(
                        jax.device_put(q, l_spec),
                        jax.device_put(qlen, l_spec1),
                        jax.device_put(t, l_spec),
                        jax.device_put(tl, l_spec1),
                        jax.device_put(c0, l_spec1))
                    e_score = np.asarray(e_score)
                    e_moves = np.asarray(e_moves)
                    e_si = np.asarray(e_si)
                    e_tb = np.asarray(e_tb)
                    for li, (r, kk, tid, bstart, ws, tlen, c0v) \
                            in enumerate(lchunk):
                        score = int(e_score[li])
                        if score <= 0:
                            continue
                        rid = rows[r]
                        forward = bool(c_strand[r, kk])
                        codes = q_fwd[r][:lens[r]] if forward \
                            else q_rev[r][:lens[r]]
                        win = self.db.get_codes(tid)[
                            bstart + ws:bstart + ws + NT]
                        qb = int(e_si[li])
                        tb = int(e_tb[li])
                        qstr, tstr, qe, te = moves_to_strings(
                            e_moves[li], codes, qb, tb, win)
                        rb = bstart + ws + tb
                        re = bstart + ws + te
                        gdiag = bstart + int(c_diag[r, kk])
                        cand = Candidate(tid=tid, forward=forward,
                                         diag=gdiag,
                                         hits=int(c_cnt[r, kk]),
                                         score=float(c_score[r, kk]))
                        self._emit(read_db, rid, cand, codes, score,
                                   qstr, tstr, qb, qe, rb, re, out,
                                   best_per_read)
                bar.update(len(chunk))
                consumed += len(chunk)
                if ck is not None and ck.should_flush():
                    ck.flush(out.alignments[watermark:], consumed)
                    watermark = len(out)
        if ck is not None:
            ck.close()

        kept = [a for a in out
                if a.score >= cfg.delta * best_per_read.get(
                    a.query_name, a.score)]
        n_dup = getattr(self, "n_dedup_suppressed", 0)
        if n_dup:
            logger.info("suppressed %d duplicate alignment(s) "
                        "(last-%d-record window)", n_dup, 8)
        res = AlignmentSet(kept)
        res.sort_by_score()
        return res

    @staticmethod
    def _is_duplicate(out: AlignmentSet, a: Alignment) -> bool:
        """Adjacent seeding candidates can converge to the same alignment
        after band drift; keep the first (higher-ranked) one."""
        for other in out.alignments[-8:]:
            if (other.query_name == a.query_name
                    and other.ref_name == a.ref_name
                    and other.forward == a.forward
                    and min(other.re, a.re) - max(other.rb, a.rb)
                    > 0.5 * (a.re - a.rb)):
                return True
        return False


def align_chunked(target_db: SeqDatabase, query_db: SeqDatabase,
                  cfg: AlignerConfig, progress: bool = False,
                  mesh=None, checkpoint_path: str | None = None
                  ) -> AlignmentSet:
    """Contig->reference alignment via fixed-size pseudo-reads.

    Mirrors script/long2ref.py: chunk each contig into ``chunk_len`` pieces,
    align the pieces, then rewrite coordinates back to whole-contig space.
    The emitted records use the 10-field header the reference's
    MummerAlignDatabaseV2 consumes.
    """
    chunk = cfg.chunk_len
    pieces = []
    origin = []  # (ctg_id, chunk_idx)
    for cid in range(len(query_db)):
        codes = query_db.get_codes(cid)
        n_parts = (len(codes) + chunk - 1) // chunk
        for p in range(n_parts):
            s = p * chunk
            e = min(len(codes), (p + 1) * chunk)
            pieces.append((f"{cid}_{p}",
                           codes[s:e]))
            origin.append((cid, p))

    from ..io.seqdb import decode_seq
    piece_db = SeqDatabase((nm, decode_seq(c)) for nm, c in pieces)
    aligner = LongReadAligner(target_db, cfg, progress=progress,
                              mesh=mesh, checkpoint_path=checkpoint_path)
    raw = aligner.align_reads(piece_db)

    out = AlignmentSet()
    for a in raw:
        cid_s, p_s = a.query_name.split("_")
        cid, p = int(cid_s), int(p_s)
        offset = p * chunk
        out.append(Alignment(
            query_name=query_db.names[cid], ref_name=a.ref_name,
            forward=a.forward, score=a.score,
            qb=a.qb + offset, qe=a.qe + offset,
            qsize=query_db.size(cid),
            rb=a.rb, re=a.re, rsize=a.rsize,
            qstr=a.qstr, tstr=a.tstr))
    return out
