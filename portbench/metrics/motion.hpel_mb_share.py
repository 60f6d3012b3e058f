"""motion.hpel_mb_share: the share of the P frames' inter MBs whose vector
is half-pel (an odd component), from the program's counts
`motion.hpel_mbs` and `motion.inter_mbs` (GopEngine.download of a format-4
encode), over the counts that start in the window's untraced part, in %.
The cell's witness that its traffic takes format 4's half-pel path: the
streams are bit-exact, so no change to the program moves it on the same
content. None where the program counts neither (formats 1-3, or a program
without the counts)."""

from portbench import program_spans


def read(rec):
    recs = program_spans.records(program_spans.window_ns(rec))
    if recs is None:
        return None
    hpel = [r[5] for r in recs if r[1] == "motion.hpel_mbs" and r[5] is not None]
    inter = [r[5] for r in recs if r[1] == "motion.inter_mbs" and r[5] is not None]
    if not hpel or not sum(inter):
        return None
    return 100 * sum(hpel) / sum(inter)
