"""online_p95_ms: the 95th percentile over every exchange of the window of
the time from the client's first online frame to the intersection in hand
(the frames, the server's step, the client's decrypt and the extraction);
host clock."""

import statistics


def read(run):
    lat = run.latencies_ms
    return statistics.quantiles(lat, n=20)[18] if len(lat) >= 20 else None
