"""K9, the TINYVIT stand-in's attention (tinyvit_port.attention): q, k and v
read, the output written, its two products.

Sizes (the builder's, per image): `tokens`, `dim`."""

CATEGORY = "K9 tiny_attention (port)"
PATTERN = r"tiny_attention_kernel"
RANK = 9


def launches() -> int:
    import tinyvit_port

    return tinyvit_port.attention_launches


def work(sizes: dict, batch: int, max_gt: int) -> tuple:
    n, d = sizes["tokens"], sizes["dim"]
    return batch * 4 * n * d * 4, batch * 4 * n * n * d
