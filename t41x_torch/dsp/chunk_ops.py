"""Composed chunk operators of linear filter cascades (NumPy, float64).

A copy of `t41x.kernels.frontend_pallas`'s design functions
(`_compose_cascade_ops`, `_compose_systems`, `_zoom_chunk_ops`), so the
port never imports JAX; `tests/test_torch_design.py` pins them equal.
A whole cascade (biquads, optionally a short FIR and a decimation) is
one state-space system; over a chunk of K samples it unrolls into the
matrices of two products on [x | state]: the chunk's outputs and the
next state.  The 14-band receive EQ (`dsp.eq`) and the zoom 2^z
panadapter tap of the fused front end (`kernels.frontend`) run on them.
The composite state is the concatenation of the per-stage normal-form
states (`iir.stage_normal_form`), so it is interchangeable with
`iir.BiquadChunked` state.
"""

from __future__ import annotations

import numpy as np

from t41x_torch.dsp import iir


def compose_cascade_ops(b: np.ndarray, a: np.ndarray, K: int):
    """Compose an S-stage df2T biquad cascade into ONE 2S-state linear
    system and precompute its K-sample chunk operators (float64):

        y_chunk  = x @ L.T + s @ R.T        L: (K,K)  R: (K,2S)
        s_next   = s @ AK.T + x @ G         G: (K,2S) AK: (2S,2S)

    The composite state vector is the CONCATENATION of the per-stage
    normal-form states, interchangeable with `iir.BiquadChunked` state
    laid out (..., S, 2).reshape(..., 2S)."""
    b = np.atleast_2d(np.asarray(b, np.float64))
    a = np.atleast_2d(np.asarray(a, np.float64))
    S = b.shape[0]
    A_c = np.zeros((0, 0))
    B_c = np.zeros((0,))
    C_c = np.zeros((0,))
    D_c = 1.0
    for s in range(S):
        # balanced normal-form stages: the df2T companion form's chunk
        # powers are ill-conditioned for near-unity poles
        As, Bs, Cs, Ds = iir.stage_normal_form(b[s], a[s])
        m = A_c.shape[0]
        A_new = np.zeros((m + 2, m + 2))
        A_new[:m, :m] = A_c
        A_new[m:, :m] = np.outer(Bs, C_c)
        A_new[m:, m:] = As
        A_c = A_new
        B_c = np.concatenate([B_c, Bs * D_c])
        C_c = np.concatenate([Ds * C_c, Cs])
        D_c = Ds * D_c
    S2 = 2 * S
    P = np.empty((K + 1, S2, S2))
    P[0] = np.eye(S2)
    for m in range(K):
        P[m + 1] = A_c @ P[m]
    h = np.empty(K)
    h[0] = D_c
    for n in range(1, K):
        h[n] = C_c @ P[n - 1] @ B_c
    L = np.zeros((K, K))
    for n in range(K):
        L[n, : n + 1] = h[: n + 1][::-1]
    R = np.einsum("d,ndk->nk", C_c, P[:K])           # (K, S2)
    G = np.stack([P[K - 1 - j] @ B_c for j in range(K)])  # (K, S2)
    return L, R, G, P[K]


def compose_systems(sys1, sys2):
    """Cascade two state-space systems (input -> sys1 -> sys2)."""
    A1, B1, C1, D1 = sys1
    A2, B2, C2, D2 = sys2
    m, n = A1.shape[0], A2.shape[0]
    A = np.zeros((m + n, m + n))
    A[:m, :m] = A1
    A[m:, :m] = np.outer(B2, C1)
    A[m:, m:] = A2
    B = np.concatenate([B1, B2 * D1])
    Cv = np.concatenate([D2 * C1, C2])
    return A, B, Cv, D2 * D1


def zoom_chunk_ops(b: np.ndarray, a: np.ndarray, h: np.ndarray,
                   m: int, K: int):
    """Compose the WHOLE zoom tap — S-stage biquad cascade, t-tap FIR,
    decimate-by-m — into one K-sample chunk operator pair with the
    decimation folded in as static output-row selection (float64):

        y_dec  = [x | s] @ Wy        Wy: (K+S, K/m)
        s_next = [x | s] @ Ws        Ws: (K+S, S)

    with S = 2*stages + t - 1 composite states ordered
    [stage0 s1,s2, ..., u[n-1], u[n-2], u[n-3]]: the IIR part is
    interchangeable with per-stage `iir.BiquadChunked` (normal-form)
    states, the FIR part with the `fir.fir_state` history REVERSED
    (newest first).  Output rows are the in-chunk sample indices m-1,
    2m-1, ... (fir_decimate's newest-sample phase).  Returns (Wy, Ws, S).
    """
    b = np.atleast_2d(np.asarray(b, np.float64))
    a = np.atleast_2d(np.asarray(a, np.float64))
    h = np.asarray(h, np.float64)
    t = len(h)
    A_c = np.zeros((0, 0))
    B_c = np.zeros((0,))
    C_c = np.zeros((0,))
    D_c = 1.0
    for s in range(b.shape[0]):
        stage = iir.stage_normal_form(b[s], a[s])
        A_c, B_c, C_c, D_c = compose_systems((A_c, B_c, C_c, D_c), stage)
    # FIR as a shift register: states (u[n-1], ..., u[n-t+1])
    nf = t - 1
    Af = np.zeros((nf, nf))
    Af[1:, :-1] = np.eye(nf - 1)
    Bf = np.zeros(nf)
    Bf[0] = 1.0
    A_c, B_c, C_c, D_c = compose_systems((A_c, B_c, C_c, D_c),
                                         (Af, Bf, h[1:], h[0]))
    S = A_c.shape[0]
    P = np.empty((K + 1, S, S))
    P[0] = np.eye(S)
    for n in range(K):
        P[n + 1] = A_c @ P[n]
    h_imp = np.empty(K)
    h_imp[0] = D_c
    for n in range(1, K):
        h_imp[n] = C_c @ P[n - 1] @ B_c
    sel = np.arange(m - 1, K, m)                      # output sample rows
    L_sel = np.zeros((len(sel), K))
    for ji, n in enumerate(sel):
        L_sel[ji, : n + 1] = h_imp[: n + 1][::-1]
    R_sel = np.stack([C_c @ P[n] for n in sel])       # (K/m, S)
    G = np.stack([P[K - 1 - j] @ B_c for j in range(K)])  # (K, S)
    Wy = np.concatenate([L_sel.T, R_sel.T])           # (K+S, K/m)
    Ws = np.concatenate([G, P[K].T])                  # (K+S, S)
    return Wy, Ws, S
