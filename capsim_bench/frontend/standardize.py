"""Standardization transformation (paper §V-A, Fig 5).

Raw assembly instructions become a structured token sequence:

    <REP> <OPCODE> op <DSTS> d... </DSTS> <SRCS> s... </SRCS>
          [<MEM> base <CONST> </MEM>] <END>

- constants are replaced by the token ``<CONST>`` (Fig 5a)
- memory operands get their own segment (Fig 5b)
- implicit control registers (CR written by compares, LR by calls, CTR by
  bdnz, NIA by every branch, CIA read by every branch) are inserted
  manually (Fig 5c) — they are not spelled in the assembly but matter to
  the execution flow
- all four segments are optional; <REP> is the learnable representation
  slot whose encoder output becomes the instruction's ideal-execution-time
  vector (Eq 5-8)

The same vocabulary also covers the context matrix's value tokens
(``<B00>``..``<BFF>``, one per byte; context.py) so one embedding table
serves both streams.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np

from capsim_bench.frontend.isa import OPCODES, REGS, Instruction

# --------------------------------------------------------------------------- #
# Vocabulary
# --------------------------------------------------------------------------- #

PAD = "<PAD>"
REP = "<REP>"
END = "<END>"
OPCODE = "<OPCODE>"
DSTS, DSTS_E = "<DSTS>", "</DSTS>"
SRCS, SRCS_E = "<SRCS>", "</SRCS>"
MEM, MEM_E = "<MEM>", "</MEM>"
CONST = "<CONST>"

SPECIAL_TOKENS = (PAD, REP, END, OPCODE, DSTS, DSTS_E, SRCS, SRCS_E,
                  MEM, MEM_E, CONST)

BYTE_TOKENS = tuple(f"<B{b:02X}>" for b in range(256))

# Multicore context channel name (context.py): the core-id pseudo-register
# heading one extra 9-token row appended to the context matrix.  Appended
# AFTER the byte tokens so every pre-existing token id is unchanged.
CORE = "<CORE>"


@dataclasses.dataclass(frozen=True)
class Vocab:
    token_to_id: Dict[str, int]
    id_to_token: Tuple[str, ...]

    @property
    def size(self) -> int:
        return len(self.id_to_token)

    def __getitem__(self, tok: str) -> int:
        return self.token_to_id[tok]

    def encode(self, tokens: Sequence[str]) -> List[int]:
        t2i = self.token_to_id
        return [t2i[t] for t in tokens]

    def signature(self) -> str:
        """Content hash of the id -> token mapping.  Any vocabulary change
        (token added, reordered, renamed) yields a new signature — the
        vocab component of the persistent RT store's key."""
        import hashlib
        blob = "\x00".join(self.id_to_token).encode()
        return hashlib.sha256(blob).hexdigest()[:16]


def build_vocab() -> Vocab:
    toks: List[str] = list(SPECIAL_TOKENS)
    toks.extend(sorted(OPCODES))
    toks.extend(REGS)
    toks.extend(BYTE_TOKENS)
    toks.append(CORE)                      # keep last: ids above are frozen
    assert len(set(toks)) == len(toks), "duplicate vocabulary tokens"
    return Vocab(token_to_id={t: i for i, t in enumerate(toks)},
                 id_to_token=tuple(toks))


# The PAD token must be id 0 so zero-padded arrays are valid token ids.
assert SPECIAL_TOKENS[0] == PAD


# --------------------------------------------------------------------------- #
# Instruction -> standardized tokens
# --------------------------------------------------------------------------- #

def standardize(inst: Instruction) -> List[str]:
    """Fig 5 transformation with implicit-register insertion (Fig 5c)."""
    info = inst.info
    toks = [REP, OPCODE, inst.op]

    dsts = list(inst.dsts)
    if info.writes_cr and "CR" not in dsts:
        dsts.append("CR")
    if info.writes_lr and "LR" not in dsts:
        dsts.append("LR")
    if info.uses_ctr and "CTR" not in dsts:
        dsts.append("CTR")
    if info.is_branch and "NIA" not in dsts:
        dsts.append("NIA")
    if dsts:
        toks.append(DSTS)
        toks.extend(dsts)
        toks.append(DSTS_E)

    srcs = list(inst.srcs)
    if inst.op == "bc" and "CR" not in srcs:
        srcs.append("CR")
    if info.uses_ctr and "CTR" not in srcs:
        srcs.append("CTR")
    if inst.op == "blr" and "LR" not in srcs:
        srcs.append("LR")
    if info.is_branch and "CIA" not in srcs:
        srcs.append("CIA")
    has_const = inst.imm is not None or (info.is_branch and
                                         inst.target is not None)
    if srcs or has_const:
        toks.append(SRCS)
        toks.extend(srcs)
        if has_const:
            toks.append(CONST)
        toks.append(SRCS_E)

    if inst.mem_base is not None:
        toks.append(MEM)
        toks.append(inst.mem_base)
        toks.append(CONST)
        toks.append(MEM_E)

    toks.append(END)
    return toks


def max_token_len() -> int:
    """Upper bound on standardized length across the ISA (for L_token)."""
    # <REP> <OPCODE> op + <DSTS> d CR LR CTR NIA </DSTS>
    # + <SRCS> s s s CR CTR LR CIA <CONST> </SRCS> + <MEM> b <CONST> </MEM>
    # + <END>; the practical max over OPCODES is much smaller.
    return 16


def encode_instruction(inst: Instruction, vocab: Vocab,
                       l_token: int) -> np.ndarray:
    """(l_token,) int32, zero (=<PAD>) padded."""
    ids = vocab.encode(standardize(inst))
    assert len(ids) <= l_token, (
        f"standardized length {len(ids)} > L_token={l_token}: "
        f"{standardize(inst)}")
    out = np.zeros(l_token, np.int32)
    out[: len(ids)] = ids
    return out


def encode_clip(insts: Sequence[Instruction], vocab: Vocab, l_clip: int,
                l_token: int) -> Tuple[np.ndarray, np.ndarray]:
    """((l_clip, l_token) int32 tokens, (l_clip,) float32 mask)."""
    toks = np.zeros((l_clip, l_token), np.int32)
    mask = np.zeros(l_clip, np.float32)
    n = min(len(insts), l_clip)
    for i in range(n):
        toks[i] = encode_instruction(insts[i], vocab, l_token)
        mask[i] = 1.0
    return toks, mask


# --------------------------------------------------------------------------- #
# Batched clip encoding
# --------------------------------------------------------------------------- #

def _inst_key(inst: Instruction) -> tuple:
    """Everything ``standardize`` reads: constants and memory offsets only
    matter through their presence (Fig 5a), so instructions collapse onto a
    small set of shapes — traces are loopy and the hit rate is ~99%."""
    return (inst.op, inst.dsts, inst.srcs, inst.imm is not None,
            inst.mem_base, inst.target is not None)


class ClipEncoder:
    """Vectorized batch path over ``encode_clip`` with a standardized-row
    memo.  ``encode(clips)`` returns the same bits as stacking
    ``encode_clip`` per clip; the memo turns the per-instruction dict walks
    of ``standardize`` into a single tuple-key lookup."""

    def __init__(self, vocab: Vocab, l_clip: int, l_token: int):
        self.vocab = vocab
        self.l_clip = l_clip
        self.l_token = l_token
        self._memo: Dict[tuple, np.ndarray] = {}

    def encode_row(self, inst: Instruction) -> np.ndarray:
        key = _inst_key(inst)
        row = self._memo.get(key)
        if row is None:
            row = encode_instruction(inst, self.vocab, self.l_token)
            row.setflags(write=False)
            self._memo[key] = row
        return row

    def encode(self, clips: Sequence[Sequence[Instruction]]
               ) -> Tuple[np.ndarray, np.ndarray]:
        """((N, l_clip, l_token) int32 tokens, (N, l_clip) float32 mask)."""
        n = len(clips)
        toks = np.zeros((n, self.l_clip, self.l_token), np.int32)
        mask = np.zeros((n, self.l_clip), np.float32)
        for ci, insts in enumerate(clips):
            k = min(len(insts), self.l_clip)
            for i in range(k):
                toks[ci, i] = self.encode_row(insts[i])
            mask[ci, :k] = 1.0
        return toks, mask


def encode_clips(clips: Sequence[Sequence[Instruction]], vocab: Vocab,
                 l_clip: int, l_token: int) -> Tuple[np.ndarray, np.ndarray]:
    """One-shot batch encode (fresh memo) over object clips.  The engine
    itself tokenizes via the columnar gather path below; this object
    path remains for ad-hoc callers and differential tests."""
    return ClipEncoder(vocab, l_clip, l_token).encode(clips)


# --------------------------------------------------------------------------- #
# Columnar gather path
# --------------------------------------------------------------------------- #
#
# Standardization depends only on the *static* instruction, so a
# ``CompiledProgram.token_table(vocab, l_token)`` row gathered by trace pc
# is bitwise the row ``encode_instruction`` would produce.  Tokenizing a
# fixed-sliced trace then needs no per-instruction Python at all: one
# fancy-index gather plus a reshape.

def encode_fixed_clips(token_table: np.ndarray, pcs: np.ndarray,
                       l_min: int, l_clip: int
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Gather-tokenize a fixed-sliced columnar trace.

    ``token_table`` is the program's ``(n_static, l_token)`` table and
    ``pcs`` the trace pc column; clips are the ``slice_fixed`` partition
    (``l_min`` windows + remainder).  Returns the same
    ``((n_clips, l_clip, l_token) int32, (n_clips, l_clip) float32)``
    bits as ``ClipEncoder.encode`` over the object clips.
    """
    l_token = token_table.shape[1]
    n = pcs.shape[0]
    k_full, rem = n // l_min, n % l_min
    n_clips = k_full + (1 if rem else 0)
    toks = np.zeros((n_clips, l_clip, l_token), np.int32)
    mask = np.zeros((n_clips, l_clip), np.float32)
    rows = token_table[pcs]
    w = min(l_min, l_clip)
    if k_full:
        full = rows[: k_full * l_min].reshape(k_full, l_min, l_token)
        toks[:k_full, :w] = full[:, :w]
        mask[:k_full, :w] = 1.0
    if rem:
        r = min(rem, l_clip)
        toks[k_full, :r] = rows[n - rem: n - rem + r]
        mask[k_full, :r] = 1.0
    return toks, mask


def gather_bounded_clip(rows: np.ndarray, start: int, end: int,
                        lead_dup: bool, l_clip: int) -> np.ndarray:
    """Token rows for one Algorithm-1-bounded clip, truncated to
    ``l_clip``.  ``lead_dup`` reproduces the slicer's quirk: Algorithm 1
    seeds its block with I[0], so the interval's clip 0 carries a
    duplicated leading instruction."""
    body = rows[start:end]
    if lead_dup:
        body = np.concatenate([rows[:1], body])
    return body[:l_clip]


def bounded_clip_keys(rows: np.ndarray, bounds: np.ndarray) -> List[bytes]:
    """Sampler content keys for Algorithm-1-bounded clips: the bytes of
    each clip's (untruncated) gathered standardized-token rows — exactly
    what Fig-5 standardization preserves of the instructions.  Shared by
    the single- and multicore dataset builds so the occurrence sampler
    sees identical keys through either."""
    n = rows.shape[0]
    return [gather_bounded_clip(rows, int(s), int(e), j == 0,
                                max(n + 1, 1)).tobytes()
            for j, (s, e) in enumerate(bounds)]


def encode_bounded_clips(rows: np.ndarray, bounds: np.ndarray,
                         keep: Sequence[int], l_clip: int
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """Tokenize the kept Algorithm-1 clips of one interval trace.

    ``rows`` is the trace's gathered ``token_table[trace.pc]`` matrix,
    ``bounds`` the ``(k, 2)`` Algorithm-1 bounds, ``keep`` the sampler's
    surviving clip indices.  Returns ``((n_keep, l_clip, l_token) int32,
    (n_keep, l_clip) float32)`` — the bounded-slicing analogue of
    ``encode_fixed_clips``, shared by the single- and multicore builds.
    """
    l_token = rows.shape[1]
    toks = np.zeros((len(keep), l_clip, l_token), np.int32)
    mask = np.zeros((len(keep), l_clip), np.float32)
    for row_i, j in enumerate(keep):
        body = gather_bounded_clip(rows, int(bounds[j, 0]),
                                   int(bounds[j, 1]), j == 0, l_clip)
        k = body.shape[0]
        toks[row_i, :k] = body
        mask[row_i, :k] = 1.0
    return toks, mask


def dedupe_token_rows(rows: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Content-dedupe standardized token rows: (k, l_token) ->
    ``(uniq (n_unique, l_token) int32, inverse (k,) int32)`` with
    ``uniq[inverse]`` bitwise equal to ``rows``.

    Token ids are non-negative, so when an all-<PAD> (zero) row is present
    it lexicographically sorts to local id 0 — the convention the RT
    cache's pad slot and ``data.dataset.indexed_clips`` both rely on.
    """
    uniq, inv = np.unique(rows, axis=0, return_inverse=True)
    return (np.ascontiguousarray(uniq, np.int32),
            inv.reshape(rows.shape[0]).astype(np.int32))


def dedup_bucket(n: int, cap: int) -> int:
    """Smallest ladder bucket (32, 48, 64, 96, 128, 192, 256, ...) that
    holds ``n`` unique tokens, capped at ``cap``.  The 1.5x/1.33x ladder
    keeps the fused serving path's jit-shape count small while wasting at
    most ~50% padding over the true unique count."""
    b = 32
    while b < n:
        b = b * 3 // 2 if (b & (b - 1)) == 0 else (b // 3) * 4
    return min(b, cap)


def dedupe_context_tokens(ctx: np.ndarray, bucket: int = None
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """Dedupe each context row's token ids into (unique ids, counts).

    ctx: (n, M) int32 token ids.  Returns ``(uniq (n, U) int32,
    counts (n, U) float32)`` with ``counts[i].sum() == M`` for every row
    and unused slots carrying id 0 / count 0.  U is ``bucket`` when given
    (ValueError if any row has more uniques), else the auto
    ``dedup_bucket`` size for the batch's max unique count.

    The block encoder adds no positional encoding to the context stream,
    so it is permutation-equivariant over context rows: attending over a
    token that occurs c times equals attending over ONE copy whose
    exponentiated score carries weight c (kernels/fused_serving).  This
    host-side dedupe is what turns the fused serving step's M=360
    attention into a ~U=64-128 attention.
    """
    ctx = np.ascontiguousarray(ctx, np.int32)
    n, m = ctx.shape
    srt = np.sort(ctx, axis=1)
    first = np.ones((n, m), bool)
    first[:, 1:] = srt[:, 1:] != srt[:, :-1]
    max_u = int(first.sum(1).max()) if n else 1
    if bucket is None:
        bucket = dedup_bucket(max_u, m)
    elif max_u > bucket:
        raise ValueError(
            f"context row has {max_u} unique tokens > bucket {bucket}")
    rank = np.cumsum(first, axis=1) - 1                  # unique slot per elt
    rows = np.arange(n)[:, None]
    uniq = np.zeros((n, bucket), np.int32)
    counts = np.zeros((n, bucket), np.float32)
    uniq[rows, rank] = srt          # duplicate writes carry the same value
    np.add.at(counts, (rows, rank), 1.0)
    return uniq, counts


def fixed_clip_indices(static_ids: np.ndarray, pcs: np.ndarray,
                       l_min: int, l_clip: int, pad_id: int = 0
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """RT-cache analogue of ``encode_fixed_clips``: same ``slice_fixed``
    partition and mask, but each instruction becomes one int32 RT-table
    row id instead of an (l_token,) token row — the front-end never
    materializes token tensors at all.

    ``static_ids`` maps static pc -> global RT row id (from
    ``RTCache.ensure_rows`` over the program's token table); ``pad_id``
    (default 0, the cache's all-<PAD> row) fills masked slots.  Returns
    ``((n_clips, l_clip) int32 rt_idx, (n_clips, l_clip) float32 mask)``
    with mask bitwise equal to the ``encode_fixed_clips`` mask.
    """
    n = pcs.shape[0]
    k_full, rem = n // l_min, n % l_min
    n_clips = k_full + (1 if rem else 0)
    idx = np.full((n_clips, l_clip), pad_id, np.int32)
    mask = np.zeros((n_clips, l_clip), np.float32)
    ids = static_ids[pcs]
    w = min(l_min, l_clip)
    if k_full:
        idx[:k_full, :w] = ids[: k_full * l_min].reshape(k_full, l_min)[:, :w]
        mask[:k_full, :w] = 1.0
    if rem:
        r = min(rem, l_clip)
        idx[k_full, :r] = ids[n - rem: n - rem + r]
        mask[k_full, :r] = 1.0
    return idx, mask
