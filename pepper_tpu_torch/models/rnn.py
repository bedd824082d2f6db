"""Recurrent cells in PyTorch, semantics-compatible with torch.nn.LSTM /
torch.nn.GRU (gate order and bidirectional output layout) and with the JAX
package's models/rnn.py, whose weight layout they keep, right-multiplied:

  LSTM  w_ih: (F, 4H)  w_hh: (H, 4H)  b: (4H,) [b_ih + b_hh pre-summed],
        gates ordered (i, f, g, o)
  GRU   w_ih: (F, 3H)  w_hh: (H, 3H)  b_ih, b_hh: (3H,), gates ordered
        (r, z, n); b_hh stays apart because torch applies it inside the
        reset gate: n = tanh(W_in x + b_in + r * (W_hn h + b_hn))

The input projection of every step is hoisted out of the loop into one
(B*T, F) x (F, G*H) product; the loop keeps only the (B, H) x (H, G*H)
recurrent product.  This is the eager path (training shapes, reference
checks, the no_cnn family, the polish consensus with PEPPER_GRU_FUSED=0);
inference runs the kernels in ops/lstm_kernel.py and ops/gru_kernel.py.
"""

from __future__ import annotations

import torch

from ..ops.gru_kernel import gru_cell


def lstm_recurrence(xw, w_hh, h0=None, c0=None, reverse=False):
    """LSTM recurrence over PRECOMPUTED input projections.
    xw: (T, B, 4H) = x@w_ih + b.  Returns (ys (T, B, H), (hT, cT)); the
    state is kept in xw's dtype."""
    T, B, _ = xw.shape
    H = w_hh.shape[0]
    if h0 is None:
        h0 = torch.zeros((B, H), dtype=xw.dtype, device=xw.device)
    if c0 is None:
        c0 = torch.zeros((B, H), dtype=xw.dtype, device=xw.device)
    h, c = h0, c0
    ys = torch.empty((T, B, H), dtype=xw.dtype, device=xw.device)
    for step in range(T):
        t = T - 1 - step if reverse else step
        gates = xw[t] + h @ w_hh
        i, f, g, o = gates.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        ys[t] = h
    return ys, (h, c)


def lstm_scan(x, w_ih, w_hh, b, h0=None, c0=None, reverse=False):
    """Unidirectional LSTM over x:(B,T,F) -> outputs (B,T,H), (hT, cT)."""
    xw = torch.einsum("btf,fg->tbg", x, w_ih) + b   # (T, B, 4H)
    ys, (hT, cT) = lstm_recurrence(xw, w_hh, h0, c0, reverse=reverse)
    return ys.transpose(0, 1), (hT, cT)


def bilstm(x, params, allow_kernel=True):
    """Bidirectional LSTM; output (B,T,2H) laid out [fwd, bwd] like torch.

    allow_kernel runs the recurrence kernel (ops/lstm_kernel.py's
    bilstm_pallas) where use_pallas_lstm says so: on a CUDA tensor unless
    PEPPER_LSTM_KERNEL=0, on any with PEPPER_LSTM_KERNEL=1.  Training
    passes allow_kernel=False (the kernel has no backward) and runs two
    eager scans."""
    if allow_kernel:
        from ..ops.lstm_kernel import bilstm_pallas, use_pallas_lstm

        if use_pallas_lstm(x.device):
            return bilstm_pallas(x, params)
    fwd, _ = lstm_scan(x, params["w_ih_f"], params["w_hh_f"], params["b_f"])
    bwd, _ = lstm_scan(x, params["w_ih_b"], params["w_hh_b"], params["b_b"],
                       reverse=True)
    return torch.cat([fwd, bwd], dim=-1)


def gru_scan(x, w_ih, w_hh, b_ih, b_hh, h0=None, reverse=False):
    """Unidirectional GRU matching torch.nn.GRU semantics over x: (B, T, F).
    Returns (outputs (B, T, H), hT (B, H)); the state is kept in the dtype
    the products give."""
    B, T, _ = x.shape
    H = w_hh.shape[0]
    h = (torch.zeros((B, H), dtype=x.dtype, device=x.device) if h0 is None
         else h0)
    xw = torch.einsum("btf,fg->tbg", x, w_ih) + b_ih   # (T, B, 3H)
    ys = [None] * T
    for step in range(T):
        t = T - 1 - step if reverse else step
        h = gru_cell(xw[t], h @ w_hh + b_hh, h)
        ys[t] = h
    return torch.stack(ys, dim=1), h


def bigru(x, params, h0_f=None, h0_b=None):
    """Bidirectional GRU; returns (B, T, 2H) plus final hidden (hf, hb)."""
    fwd, hf = gru_scan(x, params["w_ih_f"], params["w_hh_f"],
                       params["b_ih_f"], params["b_hh_f"], h0=h0_f)
    bwd, hb = gru_scan(x, params["w_ih_b"], params["w_hh_b"],
                       params["b_ih_b"], params["b_hh_b"], h0=h0_b,
                       reverse=True)
    return torch.cat([fwd, bwd], dim=-1), (hf, hb)


def uniform_init(generator, shape, scale, dtype=torch.float32, device=None):
    """U(-scale, scale) drawn from `generator` (a torch.Generator)."""
    u = torch.rand(shape, generator=generator, dtype=torch.float32)
    return ((2.0 * u - 1.0) * scale).to(dtype=dtype, device=device)


def init_lstm_params(generator, in_features, hidden, dtype=torch.float32,
                     device=None):
    """Bidirectional LSTM params; torch's U(-1/sqrt(H), 1/sqrt(H)) init."""
    scale = 1.0 / (hidden ** 0.5)
    G = 4 * hidden

    def u(shape):
        return uniform_init(generator, shape, scale, dtype, device)

    params = {}
    for d in ("f", "b"):
        params[f"w_ih_{d}"] = u((in_features, G))
        params[f"w_hh_{d}"] = u((hidden, G))
        params[f"b_{d}"] = u((G,)) + u((G,))   # two torch bias vectors summed
    return params


def init_gru_params(generator, in_features, hidden, dtype=torch.float32,
                    device=None):
    """Bidirectional GRU params; torch's U(-1/sqrt(H), 1/sqrt(H)) init."""
    scale = 1.0 / (hidden ** 0.5)
    G = 3 * hidden

    def u(shape):
        return uniform_init(generator, shape, scale, dtype, device)

    params = {}
    for d in ("f", "b"):
        params[f"w_ih_{d}"] = u((in_features, G))
        params[f"w_hh_{d}"] = u((hidden, G))
        params[f"b_ih_{d}"] = u((G,))
        params[f"b_hh_{d}"] = u((G,))
    return params


def init_linear_params(generator, in_features, out_features,
                       dtype=torch.float32, device=None):
    """torch.nn.Linear default init (kaiming-uniform a=sqrt(5) ~ U scale)."""
    scale = 1.0 / (in_features ** 0.5)
    return {
        "w": uniform_init(generator, (in_features, out_features), scale,
                          dtype, device),
        "b": uniform_init(generator, (out_features,), scale, dtype, device),
    }


def linear(x, params):
    return x @ params["w"] + params["b"]


def dropout(x, rate, generator):
    """Inverted dropout of the train-mode forwards.  `generator` is a
    torch.Generator on x's device, or an object whose uniform(shape,
    device) gives the draws (train/step.py's GlobalDropout, which draws
    over the global batch and hands each device its rows)."""
    keep = 1.0 - rate
    if isinstance(generator, torch.Generator):
        u = torch.rand(x.shape, generator=generator, device=x.device)
    else:
        u = generator.uniform(x.shape, x.device)
    return torch.where(u < keep, x / keep, torch.zeros_like(x))
