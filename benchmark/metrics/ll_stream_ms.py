"""Stream milliseconds a traced sweep of the shift and the log-likelihood
(``sweep.ll``: ``_shift``, the ll sum and its all-reduces): the program's spans
of that name summed over the traced window, over the count of its ``sweep``
roots (``gpirt_tpu_torch.utils.profiling.span_totals``). Nothing where no sweep
was recorded, or the program has no spans."""

try:
    from gpirt_tpu_torch.utils.profiling import span_totals
except ImportError:  # a program without spans
    span_totals = None


def read(run):
    totals = span_totals() if span_totals is not None else {}
    roots, block = totals.get("sweep"), totals.get("sweep.ll")
    if roots is None or block is None:
        return None
    return block.stream_ms / roots.count
