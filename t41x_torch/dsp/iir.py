"""Streaming biquads: design in NumPy, apply in torch.

The operator constructors (`_normal_form_powers`, `stage_normal_form`, the
`BiquadChunked` matrices) are a copy of `t41x.dsp.iir`'s, pinned equal
by `tests/test_torch_design.py`: one source of state coordinates, so a
carried state moves between `t41x`, the plain torch path and the CUDA
front end unchanged.  Coefficients use b=[b0,b1,b2], a=[1,a1,a2]:
    y = b0 x + s1;  s1' = b1 x - a1 y + s2;  s2' = b2 x - a2 y

`BiquadChunked` is what the chain runs.  `biquad_apply` is the direct
per-sample df2T recurrence (the oracle the chunked form is held
against), `biquad_reference` the same in NumPy float64, and
`one_pole_dc_block` the AM demod's DC-removal recurrence, each the
counterpart of `t41x.dsp.iir`'s function of the same name.
"""

from __future__ import annotations

import numpy as np
import torch


def biquad_state(channels: tuple[int, ...] = (), stages: int = 1,
                 device=None) -> torch.Tensor:
    """(..., stages, 2) zero state."""
    return torch.zeros(channels + (stages, 2), dtype=torch.float32,
                       device=device)


def biquad_apply(state: torch.Tensor, x: torch.Tensor, b, a):
    """Apply a cascade of biquad stages to a block, sample by sample.

    state: (..., S, 2) df2T state;  x: (..., N);  b, a: (S, 3) host
    coefficients (NumPy or lists) with a[:, 0] == 1.
    Returns (new_state, y).
    """
    b = torch.atleast_2d(torch.as_tensor(np.asarray(b), dtype=x.dtype,
                                         device=x.device))
    a = torch.atleast_2d(torch.as_tensor(np.asarray(a), dtype=x.dtype,
                                         device=x.device))
    s1 = [state[..., s, 0] for s in range(b.shape[0])]
    s2 = [state[..., s, 1] for s in range(b.shape[0])]
    ys = []
    for n in range(x.shape[-1]):
        v = x[..., n]
        for s in range(b.shape[0]):
            y = b[s, 0] * v + s1[s]
            s1[s] = b[s, 1] * v - a[s, 1] * y + s2[s]
            s2[s] = b[s, 2] * v - a[s, 2] * y
            v = y
        ys.append(v)
    new_state = torch.stack([torch.stack(s1, dim=-1),
                             torch.stack(s2, dim=-1)], dim=-1)
    return new_state, torch.stack(ys, dim=-1)


def biquad_reference(x: np.ndarray, b: np.ndarray,
                     a: np.ndarray) -> np.ndarray:
    """NumPy oracle: cascade of df2T biquads, zero initial state."""
    b = np.atleast_2d(b)
    a = np.atleast_2d(a)
    y = np.asarray(x, np.float64).copy()
    for s in range(b.shape[0]):
        out = np.empty_like(y)
        s1 = s2 = 0.0
        for n, v in enumerate(y):
            o = b[s, 0] * v + s1
            s1 = b[s, 1] * v - a[s, 1] * o + s2
            s2 = b[s, 2] * v - a[s, 2] * o
            out[n] = o
        y = out
    return y


def one_pole_dc_block(state: torch.Tensor, x: torch.Tensor,
                      pole: float = 0.99):
    """The AM demod's one-pole DC-removal recurrence (reference
    `Process.cpp:700-704`):  w = x + pole*w_old;  y = w - w_old.

    state: (...,) w_old;  x: (..., N).  Returns (new_state, y).
    """
    w_old = state
    ys = []
    for n in range(x.shape[-1]):
        w = x[..., n] + pole * w_old
        ys.append(w - w_old)
        w_old = w
    return w_old, torch.stack(ys, dim=-1)


def _normal_form_powers(a1: float, a2: float, k: np.ndarray, K: int,
                        P: np.ndarray):
    """Balanced, well-conditioned realization of one biquad stage and
    its chunk powers A_n^0..A_n^K (float64).

    Returns (An_pows (K+1,2,2), Bn (2,), Cn (2,)) with
    H(z) = b0 + Cn (zI - An)^-1 Bn identical to the df2T companion
    system (A=[[-a1,1],[-a2,0]], B=k, C=[1,0]).  Complex pole pairs use
    the rotation form (A_n^m = r^m * rot(m*theta), closed form); distinct
    real poles the diagonal form; repeated poles fall back to the
    companion powers `P`.  The companion form's A^K is ill-conditioned
    for the near-unity DC-blocker poles (its f32 rounding moved the
    eigenvalues and left a growing DC spur on the TPU chain).
    """
    C = np.array([1.0, 0.0])
    disc = a1 * a1 - 4.0 * a2
    if disc < -1e-30:                      # complex pair -> rotation
        p = (-a1 + 1j * np.sqrt(-disc)) / 2.0
        r, th = abs(p), np.angle(p)
        v = np.array([1.0 + 0j, p + a1])   # eigenvector of companion A
        T = np.stack([v.real, v.imag], axis=1)
        Bn = np.linalg.inv(T) @ k
        Cn = C @ T
        alpha = np.sqrt(np.linalg.norm(Bn)
                        / max(np.linalg.norm(Cn), 1e-300))
        Bn, Cn = Bn / alpha, Cn * alpha
        m = np.arange(K + 1)
        c, s = np.cos(m * th), np.sin(m * th)
        rm = r ** m
        An_pows = (np.stack([np.stack([c, s], -1),
                             np.stack([-s, c], -1)], axis=-2)
                   * rm[:, None, None])
        return An_pows, Bn, Cn
    p1 = (-a1 + np.sqrt(max(disc, 0.0))) / 2.0
    p2 = (-a1 - np.sqrt(max(disc, 0.0))) / 2.0
    if abs(p1 - p2) > 1e-9 * max(1.0, abs(p1)):  # real distinct -> diag
        T = np.array([[1.0, 1.0], [p1 + a1, p2 + a1]])
        Bn = np.linalg.inv(T) @ k
        Cn = C @ T
        al = np.sqrt(np.maximum(np.abs(Bn), 1e-300)
                     / np.maximum(np.abs(Cn), 1e-300))
        Bn, Cn = Bn / al, Cn * al
        m = np.arange(K + 1)
        An_pows = np.zeros((K + 1, 2, 2))
        An_pows[:, 0, 0] = p1 ** m
        An_pows[:, 1, 1] = p2 ** m
        return An_pows, Bn, Cn
    return P.copy(), k.copy(), C             # defective: companion form


def stage_normal_form(b_row: np.ndarray, a_row: np.ndarray):
    """(A, B, C, D) of ONE biquad stage in the balanced normal-form
    realization `BiquadChunked` uses (float64)."""
    b0, b1, b2 = np.asarray(b_row, np.float64)
    a1, a2 = float(a_row[1]), float(a_row[2])
    k = np.array([b1 - a1 * b0, b2 - a2 * b0])
    A = np.array([[-a1, 1.0], [-a2, 0.0]])
    P = np.stack([np.eye(2), A])
    pw, Bn, Cn = _normal_form_powers(a1, a2, k, 1, P)
    return pw[1], Bn, Cn, b0


class BiquadChunked:
    """Chunk-parallel streaming biquad cascade — exact df2T semantics with
    the per-sample dependency collapsed to one matmul per chunk.

    Over a chunk of K samples the state-space recurrence unrolls to
        y      = b0*x + s0 @ R.T + x @ L.T          (R: (K,2), L: (K,K))
        s_next = s0 @ AK.T + x @ G                  (G: (K,2))
    with all operators precomputed in float64 at design time and the
    state in the balanced normal-form coordinates (not df2T s1/s2).
    """

    def __init__(self, b: np.ndarray, a: np.ndarray, chunk: int = 128):
        b = np.atleast_2d(np.asarray(b, np.float64))
        a = np.atleast_2d(np.asarray(a, np.float64))
        self.stages = b.shape[0]
        self.chunk = K = int(chunk)
        self.b0 = b[:, 0].astype(np.float32)
        Rs, Ls, AKs, Gs = [], [], [], []
        for s in range(self.stages):
            a1, a2 = a[s, 1], a[s, 2]
            b0, b1, b2 = b[s]
            A = np.array([[-a1, 1.0], [-a2, 0.0]])
            k = np.array([b1 - a1 * b0, b2 - a2 * b0])
            # companion-form powers: L (the in-chunk impulse-response
            # Toeplitz) is realization-independent
            P = np.empty((K + 1, 2, 2))
            P[0] = np.eye(2)
            for m in range(K):
                P[m + 1] = A @ P[m]
            Ak = P[:K] @ k                      # (K, 2): A^m k
            L = np.zeros((K, K))
            for n in range(1, K):
                # L[n, j] = (A^(n-1-j) k)[0], j = 0..n-1
                L[n, :n] = Ak[: n][::-1, 0]

            An_pows, Bn, Cn = _normal_form_powers(a1, a2, k, K, P)
            R = np.einsum("j,njk->nk", Cn, An_pows[:K])   # R[n] = Cn A^n
            G = np.einsum("njk,k->nj", An_pows[K - 1::-1], Bn)
            Rs.append(R)
            Ls.append(L)
            AKs.append(An_pows[K])
            Gs.append(G)
        self.R = np.stack(Rs).astype(np.float32)    # (S, K, 2)
        self.L = np.stack(Ls).astype(np.float32)    # (S, K, K)
        self.AK = np.stack(AKs).astype(np.float32)  # (S, 2, 2)
        self.G = np.stack(Gs).astype(np.float32)    # (S, K, 2)
        self._on_device = {}

    def _ops(self, device):
        """(R, L, AK, G) as tensors on `device`, made once."""
        if device not in self._on_device:
            self._on_device[device] = [
                torch.from_numpy(a).to(device)
                for a in (self.R, self.L, self.AK, self.G)]
        return self._on_device[device]

    def apply(self, state: torch.Tensor, x: torch.Tensor):
        """state: (..., S, 2);  x: (..., N) float32, N % chunk == 0.
        Returns (new_state, y).

        The particular solution (x @ L.T) and the state drive (x @ G)
        of every chunk are one batched matmul each; only the 2-element
        state recursion runs chunk by chunk."""
        K = self.chunk
        N = x.shape[-1]
        assert N % K == 0, (N, K)
        lead = x.shape[:-1]
        Rs, Ls, AKs, Gs = self._ops(x.device)
        new_states = []
        for s in range(self.stages):
            R, L, AK, G = Rs[s], Ls[s], AKs[s], Gs[s]
            xs = x.reshape(lead + (N // K, K))
            part = float(self.b0[s]) * xs + xs @ L.T
            drive = xs @ G                       # (..., n_chunks, 2)
            s0 = state[..., s, :]
            starts = []
            for c in range(N // K):
                starts.append(s0)
                s0 = s0 @ AK.T + drive[..., c, :]
            y = part + torch.stack(starts, dim=-2) @ R.T
            x = y.reshape(lead + (N,))
            new_states.append(s0)
        return torch.stack(new_states, dim=-2), x
