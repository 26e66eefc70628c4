"""``hic_assemble_ms``: the ``.hic`` reader's assembly after the decode
(anchors ordered, the norm vector read and divided, the band filter), the
mean duration of a ``hic.assemble`` range (one a chromosome)."""


def read(ctx):
    spans = ctx["trace"].ranges.get("hic.assemble")
    if not spans:
        return None
    return sum(b - a for a, b in spans) / 1e3 / len(spans)
