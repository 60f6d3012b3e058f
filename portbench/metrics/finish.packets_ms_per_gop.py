"""finish.packets_ms_per_gop: host milliseconds per GOP of the program's
span `finish.packets` (GopEngine.gop_packets, called once per GOP), over
the window's untraced part."""

from portbench import program_spans


def read(rec):
    return program_spans.ms_per_gop(rec, "finish.packets", 1)
