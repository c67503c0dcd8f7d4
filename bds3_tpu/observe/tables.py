"""Text channel tables (the reference's `showChannelStatus.m`).

Kept apart from observe/plots.py so the receiver's console report needs
no plotting library.
"""
from __future__ import annotations


def channel_init_table(channels) -> str:
    """Text channel table from the post-acquisition assignment
    (showChannelStatus.m:37-56, printed by postProcessing.m:124)."""
    lines = ["Ch | PRN |  Acquired freq [Hz] | Metric",
             "---+-----+---------------------+-------"]
    for ch, c in enumerate(channels):
        lines.append(f"{ch:2d} | {c.prn:3d} | {c.acquired_freq:19.1f} | "
                     f"{c.peak_metric:6.2f}")
    return "\n".join(lines)


def channel_status_table(track, acq=None, health=None) -> str:
    """Text channel table (showChannelStatus.m:37-56), optionally with the
    C/N0 + PLL-lock health summary (observe.cn0.channel_health)."""
    lines = ["Ch | PRN |  Acquired freq [Hz] | C/N0 [dB-Hz] | PLL lock",
             "---+-----+---------------------+--------------+---------"]
    for ch in range(len(track.prns)):
        if health is not None and ch < len(health):
            h = health[ch]
            tail = (f"{h['cn0_db']:12.1f} | {h['pll_lock']:+.2f}"
                    + ("" if h["lock_ok"] else " LOW"))
        else:
            tail = f"{'-':>12} |    -"
        lines.append(f"{ch:2d} | {int(track.prns[ch]):3d} | "
                     f"{track.acquired_freq[ch]:19.1f} | {tail}")
    return "\n".join(lines)
