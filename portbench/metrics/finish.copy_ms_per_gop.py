"""finish.copy_ms_per_gop: host milliseconds per GOP of the program's span
`finish.copy` (GopEngine.download: the small columns' and the words'
copies to the host), over the window's untraced part, a download serving
the launch's gop_batch GOPs."""

from portbench import program_spans


def read(rec):
    return program_spans.ms_per_gop(rec, "finish.copy", rec["gop_batch"])
