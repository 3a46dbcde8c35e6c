"""Device idle ms a frame with no work launched: the gaps whose next
operation the host had not launched when the gap began
(``harness.idle.split``'s starved class, kept by ``trace.reduce`` as
``starved_idle_s``), over the traced window's frames."""


def read(record: dict):
    t = record["trace"]
    if not t or not t["frames"] or "starved_idle_s" not in t:
        return None
    return t["starved_idle_s"] / t["frames"] * 1e3
