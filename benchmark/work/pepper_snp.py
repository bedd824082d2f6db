"""Operations and bytes of the variant window classifier, from its widths.

Operations are the matrix products' multiply-adds, two each: the gate
sums of both LSTM layers at every step in both directions, then the five
dense layers and the head.  Bytes count each input once and each output
once: a block's windows as given (int8), the weights in the compute
dtype, and the float32 probabilities.
"""


def flops_per_item(config: dict) -> int:
    T, feats = config["window"], config["image_features"]
    H, L = config["hidden_size"], config["linear_size"]
    lstm = sum(2 * T * 2 * (fan_in + H) * 4 * H
               for fan_in in (feats, 2 * H))
    dense = 2 * T * 2 * H * L + 2 * (config["num_dense_layers"] - 1) * L * L
    head = 2 * L * config["num_type_classes"]
    return lstm + dense + head


def param_count(config: dict) -> int:
    T, feats = config["window"], config["image_features"]
    H, L = config["hidden_size"], config["linear_size"]
    lstm = sum(2 * (fan_in + H + 1) * 4 * H for fan_in in (feats, 2 * H))
    dense = (T * 2 * H + 1) * L + (config["num_dense_layers"] - 1) * (
        L + 1) * L
    return lstm + dense + (L + 1) * config["num_type_classes"]


def block_work(config: dict, rows: int, itemsize: int):
    """(operations, bytes) of one device's forward over `rows` windows."""
    inputs = rows * config["window"] * config["image_features"]
    outputs = rows * config["num_type_classes"] * 4
    return (rows * flops_per_item(config),
            inputs + param_count(config) * itemsize + outputs)
