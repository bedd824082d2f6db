"""Plain float32 PyTorch reference of PEPPER's variant window classifier
(pepper_variant/modules/python/models/simple_model.py:23-82, "TransducerGRU",
a stacked bidirectional LSTM):

  encoder  biLSTM(features -> H), zero initial state      (B, T, 2H)
  decoder  biLSTM(2H -> H), zero initial state            (B, T, 2H)
  flatten  t-major, [forward | backward] at each t        (B, T*2H)
  linear_1 .. linear_5, each followed by SELU             (B, L)
  head     Linear(L -> classes), softmax                  (B, classes)

Gates in torch.nn.LSTM's order (i, f, g, o); weights right-multiplied
(w_ih (F, 4H), w_hh (H, 4H), one summed bias (4H)), the layout of the
port's checkpoints.  Dropout is off at inference.  Matrix products run in
float32 with TF32 off; `precision` ("tf32", "fp8") rounds every product's
operands to that precision first (benchmark/precision.py), which serves
as a control of the comparison.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.precision import exact_float32, mm


def param_shapes(config: dict) -> dict:
    """{"group.leaf": (shape, scale)} of every weight, in a fixed order;
    the scales are torch's default initialisations."""
    feats, T = config["image_features"], config["window"]
    H, L = config["hidden_size"], config["linear_size"]
    classes = config["num_type_classes"]
    shapes = {}
    for layer, fan_in in (("encoder", feats), ("decoder", 2 * H)):
        for d in ("f", "b"):
            shapes[f"{layer}.w_ih_{d}"] = ((fan_in, 4 * H), H ** -0.5)
            shapes[f"{layer}.w_hh_{d}"] = ((H, 4 * H), H ** -0.5)
            shapes[f"{layer}.b_{d}"] = ((4 * H,), H ** -0.5)
    dense = [("linear_1", T * 2 * H, L)]
    dense += [(f"linear_{i}", L, L)
              for i in range(2, config["num_dense_layers"] + 1)]
    dense += [("output_layer_type", L, classes)]
    for name, fan_in, fan_out in dense:
        shapes[f"{name}.w"] = ((fan_in, fan_out), fan_in ** -0.5)
        shapes[f"{name}.b"] = ((fan_out,), fan_in ** -0.5)
    return shapes



def _lstm(x, w_ih, w_hh, b, reverse, precision):
    """One direction over x (B, T, F) -> (B, T, H)."""
    B, T, feats = x.shape
    H = w_hh.shape[0]
    xw = (mm(x.reshape(B * T, feats), w_ih, precision) + b).view(B, T, 4 * H)
    h = torch.zeros(B, H, device=x.device)
    c = torch.zeros(B, H, device=x.device)
    out = torch.empty(B, T, H, device=x.device)
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        i, f, g, o = (xw[:, t] + mm(h, w_hh, precision)).chunk(4, dim=1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        out[:, t] = h
    return out


def _bilstm(x, p, precision):
    return torch.cat([_lstm(x, p["w_ih_f"], p["w_hh_f"], p["b_f"], False,
                            precision),
                      _lstm(x, p["w_ih_b"], p["w_hh_b"], p["b_b"], True,
                            precision)], dim=2)


@torch.no_grad()
def forward(params: dict, config: dict, images: torch.Tensor,
            precision: str | None = None) -> torch.Tensor:
    """images (B, T, F) of any dtype -> class probabilities (B, classes),
    float32."""
    with exact_float32():
        x = images.float()
        x = _bilstm(_bilstm(x, params["encoder"], precision),
                    params["decoder"], precision)
        x = x.reshape(x.shape[0], -1)
        for i in range(1, config["num_dense_layers"] + 1):
            p = params[f"linear_{i}"]
            x = F.selu(mm(x, p["w"], precision) + p["b"])
        p = params["output_layer_type"]
        return torch.softmax(mm(x, p["w"], precision) + p["b"], dim=1)
