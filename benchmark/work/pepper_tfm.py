"""Operations and bytes of the transformer window classifier, from its
widths.

Operations are the products' multiply-adds, two each: the two 3x3
convolutions of the stem at every position, then in each encoder layer the
packed qkv projection, the scores and the weighted sum of v (every head,
every pair of positions), out_proj and the FFN's two products, then the
pyramid and the head.  Bytes count each input once and each output once:
a block's windows as given (int8), the weights in the compute dtype, and
the float32 probabilities.
"""


def _widths(config):
    T, feats = config["window"], config["image_features"]
    return T, feats, config["conv_channels"], config["conv_channels"] * feats


def _pyramid(config):
    T, _, _, D = _widths(config)
    sizes = [T * D, *config["pyramid"], config["num_type_classes"]]
    return list(zip(sizes[:-1], sizes[1:]))


def attention_flops(config) -> int:
    """The scores and the weighted sum of one layer, a window."""
    T, _, _, D = _widths(config)
    return 2 * 2 * T * T * D


def flops_per_item(config: dict) -> int:
    T, feats, C, D = _widths(config)
    stem = 2 * T * feats * 9 * C * (1 + C)
    layer = (2 * T * D * 3 * D + attention_flops(config) + 2 * T * D * D
             + 2 * 2 * T * D * config["ffn_size"])
    pyramid = sum(2 * a * b for a, b in _pyramid(config))
    return stem + config["num_layers"] * layer + pyramid


def param_count(config: dict) -> int:
    """Every leaf of the tree the program holds, the BatchNorm running
    statistics included."""
    _, _, C, D = _widths(config)
    stem = 9 * C + 9 * C * C + 2 * 4 * C
    ffn = config["ffn_size"]
    layer = ((D + 1) * 3 * D + (D + 1) * D + (D + 1) * ffn + (ffn + 1) * D
             + 4 * D)
    pyramid = sum((a + 1) * b for a, b in _pyramid(config))
    return stem + config["num_layers"] * layer + pyramid


def block_work(config: dict, rows: int, itemsize: int):
    """(operations, bytes) of one device's forward over `rows` windows."""
    inputs = rows * config["window"] * config["image_features"]
    outputs = rows * config["num_type_classes"] * 4
    return (rows * flops_per_item(config),
            inputs + param_count(config) * itemsize + outputs)


def attention_work(config: dict, rows: int, itemsize: int):
    """(operations, bytes) of one attention launch over `rows` windows:
    the packed qkv read once and the heads' output written once."""
    T, _, _, D = _widths(config)
    return rows * attention_flops(config), rows * T * 4 * D * itemsize
