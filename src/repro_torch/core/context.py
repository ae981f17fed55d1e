"""Context matrix construction (paper §V-B, Fig 6, Table I).

The context is the architectural register state *before* a trace clip
executes.  Each of the 40 context registers (32 GPRs + 8 specials; VSRs are
folded per the paper's FPR note) contributes 9 rows to the context matrix:

    [ <reg-name token> , <byte 7> , <byte 6> , ... , <byte 0> ]

where each byte of the 64-bit value maps to one of the 256 ``<Bxx>`` tokens
(Fig 6a: "the register's value is segmented into 16 groups based on each two
of hexadecimal numbers" — two hex digits = one byte).  Stacking all registers
yields the (M, E)-shaped context matrix after embedding, M = 40 * 9 = 360
(Fig 6b, Eq 10).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

from repro_torch.core.standardize import BYTE_TOKENS, CORE, Vocab
from repro_torch.isa.isa import CONTEXT_REGS

TOKENS_PER_REG = 9          # 1 name + 8 value bytes
CONTEXT_LEN = len(CONTEXT_REGS) * TOKENS_PER_REG
# Multicore context: one extra pseudo-register row (<CORE> name + the
# core id's 8 value bytes) appended after the architectural rows, so
# the predictor can condition on WHICH core a clip executed on.  The
# single-core layout (and every token id inside it) is unchanged.
MULTICORE_CONTEXT_LEN = CONTEXT_LEN + TOKENS_PER_REG
# Peer-channel mode appends, for every OTHER core, that core's full
# register block + its own <CORE> channel — one MULTICORE_CONTEXT_LEN
# block per core, self first — so the block encoder's context stream can
# attend across cores and learn the interference the shared-resource
# oracle prices.  All widths derive from CONTEXT_REGS/TOKENS_PER_REG;
# nothing below may hard-code 360/369.


def context_len(n_cores: int = 1, peer_channels: bool = False) -> int:
    """Context-matrix width M for a build: ``CONTEXT_LEN`` single-core,
    ``MULTICORE_CONTEXT_LEN`` per-core-tagged, ``n_cores`` such blocks
    when peer channels are mixed in.  At ``n_cores <= 1`` the layout is
    ALWAYS the single-core one — there are no peers to mix, and the N=1
    build must stay bitwise identical to ``build_dataset`` whether or
    not the flag is set."""
    if n_cores <= 1:
        return CONTEXT_LEN
    if not peer_channels:
        return MULTICORE_CONTEXT_LEN
    return n_cores * MULTICORE_CONTEXT_LEN


def validate_context_width(width: int, where: str) -> None:
    """Boundary check (dataset build / engine dispatch): a context row
    width must be one of the layouts above; anything else means a stale
    hard-coded shape or a mixed-layout batch slipped through."""
    ok = (width == CONTEXT_LEN
          or (width >= MULTICORE_CONTEXT_LEN
              and width % MULTICORE_CONTEXT_LEN == 0))
    if not ok:
        raise ValueError(
            f"{where}: context width {width} is not a known layout "
            f"(single-core {CONTEXT_LEN}, core-tagged "
            f"{MULTICORE_CONTEXT_LEN}, or k*{MULTICORE_CONTEXT_LEN} "
            f"with peer channels)")


def context_token_ids(snapshot: Dict[str, int], vocab: Vocab) -> np.ndarray:
    """snapshot: {reg_name: 64-bit value} -> (CONTEXT_LEN,) int32 ids."""
    out = np.empty(CONTEXT_LEN, np.int32)
    byte0 = vocab[BYTE_TOKENS[0]]
    i = 0
    for reg in CONTEXT_REGS:
        out[i] = vocab[reg]
        v = snapshot.get(reg, 0) & ((1 << 64) - 1)
        for shift in range(56, -8, -8):                  # big-endian bytes
            out[i + 1 + (56 - shift) // 8] = byte0 + ((v >> shift) & 0xFF)
        i += TOKENS_PER_REG
    return out


def batch_context_tokens(snapshots: Sequence[Dict[str, int]],
                         vocab: Vocab) -> np.ndarray:
    """(B, CONTEXT_LEN) int32."""
    return np.stack([context_token_ids(s, vocab) for s in snapshots])


def core_id_tokens(core_id: int, vocab: Vocab) -> np.ndarray:
    """The core-id context channel: ``(TOKENS_PER_REG,) int32`` —
    ``<CORE>`` name token followed by the big-endian bytes of the id."""
    out = np.empty(TOKENS_PER_REG, np.int32)
    out[0] = vocab[CORE]
    byte0 = vocab[BYTE_TOKENS[0]]
    v = int(core_id) & ((1 << 64) - 1)
    for shift in range(56, -8, -8):                      # big-endian bytes
        out[1 + (56 - shift) // 8] = byte0 + ((v >> shift) & 0xFF)
    return out


def context_tokens_from_matrix(snapshots: np.ndarray, vocab: Vocab,
                               core_id: Optional[int] = None) -> np.ndarray:
    """Columnar path: ``(B, 40) uint64`` snapshot matrix (rows in
    ``CONTEXT_REGS`` order, as emitted by the columnar funcsim) ->
    ``(B, CONTEXT_LEN) int32`` token ids, bitwise equal to stacking
    ``context_token_ids`` over the equivalent dicts.

    The per-register byte loop becomes one vectorized big-endian byte
    decomposition: shift the whole matrix by 56..0 and mask.

    With ``core_id`` set (the multicore engine), one extra
    ``core_id_tokens`` row is appended to every matrix —
    ``(B, MULTICORE_CONTEXT_LEN)`` out — so clips from different cores of
    one benchmark carry distinct contexts; ``core_id=None`` keeps the
    single-core layout bit for bit.
    """
    snaps = np.ascontiguousarray(snapshots, np.uint64)
    b = snaps.shape[0]
    shifts = np.arange(56, -8, -8, dtype=np.uint64)      # big-endian bytes
    bytes_ = (snaps[:, :, None] >> shifts) & np.uint64(0xFF)
    out = np.empty((b, len(CONTEXT_REGS), TOKENS_PER_REG), np.int32)
    out[:, :, 0] = np.asarray([vocab[r] for r in CONTEXT_REGS], np.int32)
    out[:, :, 1:] = bytes_.astype(np.int32) + vocab[BYTE_TOKENS[0]]
    flat = out.reshape(b, CONTEXT_LEN)
    if core_id is None:
        return flat
    chan = np.broadcast_to(core_id_tokens(core_id, vocab),
                           (b, TOKENS_PER_REG))
    return np.concatenate([flat, chan], axis=1)


def peer_context_tokens(snapshots: np.ndarray, peer_snapshots: np.ndarray,
                        core_id: int, vocab: Vocab) -> np.ndarray:
    """Peer-channel context: ``(B, n_cores * MULTICORE_CONTEXT_LEN)``.

    ``snapshots`` is core ``core_id``'s own precise ``(B, 40)`` snapshot
    matrix (state immediately before each clip start);
    ``peer_snapshots`` is the scheduler's ``(B, n_cores, 40)``
    whole-machine capture at the enclosing quantum's start
    (``multicore.run_multicore(..., peer_snapshots=True)``) — other
    cores' state cannot change inside the quantum, so their rows are
    exact; the own-core row is stale and is NOT used.

    Layout: the own core's ``MULTICORE_CONTEXT_LEN`` block first (bitwise
    ``context_tokens_from_matrix(..., core_id=core_id)``), then one
    ``<CORE>``-tagged block per peer in ascending core order.  The block
    encoder attends over all rows, so the predictor can correlate a
    clip's runtime with the peers' pointer/loop state — the contention
    context single-core clips never carry.
    """
    b, n_cores = peer_snapshots.shape[0], peer_snapshots.shape[1]
    assert snapshots.shape[0] == b, (snapshots.shape, peer_snapshots.shape)
    assert 0 <= core_id < n_cores, (core_id, n_cores)
    blocks = [context_tokens_from_matrix(snapshots, vocab, core_id=core_id)]
    for peer in range(n_cores):
        if peer == core_id:
            continue
        blocks.append(context_tokens_from_matrix(
            peer_snapshots[:, peer], vocab, core_id=peer))
    return np.concatenate(blocks, axis=1)
