"""finish.copy_gb_per_s: the bytes the program counts in
`finish.copy_bytes` (the host arrays of GopEngine.download's two copies)
over the host time of the `finish.copy` spans they were counted in, over
the window's untraced part: GB/s (bytes per ns)."""

from portbench import program_spans


def read(rec):
    part = program_spans.window_ns(rec)
    copies = program_spans.spans(part, "finish.copy")
    recs = program_spans.records(part)
    if copies is None or recs is None:
        return None
    ns = {r[0]: r[3] - r[2] for r in copies}
    # (the span's ns, the bytes it copied): one count in each span
    got = [(ns[r[4]], r[5]) for r in recs
           if r[1] == "finish.copy_bytes" and r[4] in ns]
    if not got:
        return None
    return sum(b for _, b in got) / sum(t for t, _ in got)
