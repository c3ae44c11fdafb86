"""ttfc_p90_s: the 90th percentile (nearest rank) over every stream of the
window of the seconds from calling ``generate_stream`` to its first chunk
on the host, a failed stream counted as never reaching it; the count is
printed."""
import math
import sys


def read(run):
    ttfc = sorted(math.inf if r.failed else r.ttfc for r in run.requests
                  if r.failed or r.ttfc is not None)
    if not ttfc:
        return None
    rank = math.ceil(0.9 * len(ttfc))
    print(f"[ttfc] {len(ttfc)} streams, {len(ttfc) - rank} beyond the "
          f"90th percentile, {ttfc.count(math.inf)} failed; median "
          f"{ttfc[(len(ttfc) - 1) // 2]!r} s", file=sys.stderr)
    return ttfc[rank - 1] if math.isfinite(ttfc[rank - 1]) else None
