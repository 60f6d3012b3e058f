"""finish.host_ms_per_gop: host milliseconds per GOP in the finish after
its wait for the device (GopEngine.download, GopEngine.gop_packets,
OrderedMux.push), from the harness's spans, over the GOPs not traced."""


def read(rec):
    gops = [g for g in rec["gops"] if not g["traced"] and "t_done" in g]
    if not gops:
        return None
    ms = sum(g["finish.download"] + g["finish.packets"] + g["finish.mux"]
             for g in gops) * 1e3
    return ms / (len(gops) * rec["gop_batch"])
