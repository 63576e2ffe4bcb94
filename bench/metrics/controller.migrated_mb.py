"""controller.migrated_mb: the bytes the window's rebalances migrated (the
closed-form state size S(k, w) of each moved key, as the reports give it),
in MB (1e6 bytes) per interval of the window."""


def read(run):
    if not run.reports:
        return None
    return sum(r.migrated_bytes for r in run.reports) / len(run.reports) / 1e6
