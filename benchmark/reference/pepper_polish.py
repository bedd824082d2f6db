"""Plain float32 PyTorch reference of PEPPER's polish consensus
(pepper/modules/python/models/simple_model.py:5-49 and the sliding loop of
predict.py:60-89):

  for each window of `train_window` columns, sliding by `window_jump`:
    encoder  biGRU(features -> H), initial state the carried hidden
    decoder  biGRU(2H -> H), initial state the encoder's final state
    head     Linear(2H -> classes) per column, softmax
    the carried hidden becomes the decoder's final state
  votes    the windows' probabilities added where they overlap
  label    argmax of a column's votes
  fraction the top vote over the number of windows covering the column
  phred    -10 log10(1 - fraction), 100 where fraction >= 1

Gates in torch.nn.GRU's order (r, z, n), n = tanh(W_in x + b_in + r *
(W_hn h + b_hn)); weights right-multiplied (w_ih (F, 3H), w_hh (H, 3H)).
Products in float32 with TF32 off; `precision` ("tf32", "fp8") rounds
their operands to that precision first (benchmark/precision.py), which
serves as a control of the comparison.
"""

from __future__ import annotations

import torch

from benchmark.precision import exact_float32, mm


def param_shapes(config: dict) -> dict:
    feats, H = config["image_features"], config["hidden_size"]
    classes = config["num_classes"]
    shapes = {}
    for layer, fan_in in (("encoder", feats), ("decoder", 2 * H)):
        for d in ("f", "b"):
            shapes[f"{layer}.w_ih_{d}"] = ((fan_in, 3 * H), H ** -0.5)
            shapes[f"{layer}.w_hh_{d}"] = ((H, 3 * H), H ** -0.5)
            shapes[f"{layer}.b_ih_{d}"] = ((3 * H,), H ** -0.5)
            shapes[f"{layer}.b_hh_{d}"] = ((3 * H,), H ** -0.5)
    shapes["output.w"] = ((2 * H, classes), (2 * H) ** -0.5)
    shapes["output.b"] = ((classes,), (2 * H) ** -0.5)
    return shapes



def _gru(x, p, d, h, reverse, precision):
    """One direction over x (B, T, F) from state h (B, H) -> (out (B, T,
    H), final state)."""
    B, T, feats = x.shape
    H = h.shape[1]
    xw = (mm(x.reshape(B * T, feats), p[f"w_ih_{d}"], precision)
          + p[f"b_ih_{d}"]).view(B, T, 3 * H)
    out = torch.empty(B, T, H, device=x.device)
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        xr, xz, xn = xw[:, t].chunk(3, dim=1)
        hr, hz, hn = (mm(h, p[f"w_hh_{d}"], precision)
                      + p[f"b_hh_{d}"]).chunk(3, dim=1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * hn)
        h = (1.0 - z) * n + z * h
        out[:, t] = h
    return out, h


def _bigru(x, p, hidden, precision):
    fwd, hf = _gru(x, p, "f", hidden[:, 0], False, precision)
    bwd, hb = _gru(x, p, "b", hidden[:, 1], True, precision)
    return torch.cat([fwd, bwd], dim=2), torch.stack([hf, hb], dim=1)


@torch.no_grad()
def consensus(params: dict, config: dict, images: torch.Tensor,
              precision: str | None = None):
    """images (B, seq_length, F) -> (labels (B, L) int64, fraction (B, L)
    float64, margin (B, L) float64: the top vote less the second)."""
    L, W = config["seq_length"], config["train_window"]
    jump, H = config["window_jump"], config["hidden_size"]
    with exact_float32():
        x = images.float()
        B = x.shape[0]
        hidden = torch.zeros(B, 2, H, device=x.device)
        votes = torch.zeros(B, L, config["num_classes"], device=x.device)
        cover = torch.zeros(L, device=x.device)
        for start in range(0, L - W + 1, jump):
            enc, hidden = _bigru(x[:, start:start + W], params["encoder"],
                                 hidden, precision)
            dec, hidden = _bigru(enc, params["decoder"], hidden, precision)
            logits = mm(dec, params["output"]["w"], precision) + \
                params["output"]["b"]
            votes[:, start:start + W] += torch.softmax(logits, dim=2)
            cover[start:start + W] += 1.0
        top2 = votes.double().topk(2, dim=2).values
        fraction = torch.clamp(top2[..., 0] / cover.double(), max=1.0)
        return (votes.argmax(dim=2), fraction,
                top2[..., 0] - top2[..., 1])
