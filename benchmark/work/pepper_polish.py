"""Operations and bytes of the polish consensus, from its widths.

Operations are the matrix products' multiply-adds, two each: both GRU
layers' gate sums at every column of every window in both directions,
and the per-column head.  Bytes count each input once and each output
once: a block's chunks as given (uint8), the float32 weights, and the
labels (int32) and phred (float32) of every column.
"""


def windows(config: dict) -> int:
    return (config["seq_length"] - config["train_window"]) // \
        config["window_jump"] + 1


def flops_per_item(config: dict) -> int:
    feats, H = config["image_features"], config["hidden_size"]
    steps = windows(config) * config["train_window"]
    gru = sum(2 * 2 * (fan_in + H) * 3 * H for fan_in in (feats, 2 * H))
    head = 2 * 2 * H * config["num_classes"]
    return steps * (gru + head)


def param_count(config: dict) -> int:
    feats, H = config["image_features"], config["hidden_size"]
    gru = sum(2 * ((fan_in + H) * 3 * H + 2 * 3 * H)
              for fan_in in (feats, 2 * H))
    return gru + (2 * H + 1) * config["num_classes"]


def block_work(config: dict, rows: int, itemsize: int):
    """(operations, bytes) of one device's consensus over `rows` chunks."""
    columns = rows * config["seq_length"]
    return (rows * flops_per_item(config),
            columns * config["image_features"] + param_count(config)
            * itemsize + columns * 8)
