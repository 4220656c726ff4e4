"""ingest_s: seconds of the program's host ingest during set-up, the sum
of the four `ingest.*` phases' totals in the program's phase registry
(`surel_plus_tpu_torch.utils.profiling.metrics`): the CSR build, the row
shuffle, the uploads and the walk tables, each timed from a drained
device to a drained device. None where the program records none of
them."""

from surel_plus_tpu_torch.utils.profiling import metrics

PHASES = ("ingest.csr", "ingest.shuffle", "ingest.upload", "ingest.tables")


def read(r):
    got = metrics.report()
    if not all(p in got for p in PHASES):
        return None
    return sum(got[p].total_s for p in PHASES)
