"""Host data (``data/``, through ``utils/prefetch.Prefetcher``): host ms to
produce one batch of the data set handed to ``Trainer``, on the loader's
thread, averaged over every batch of the window."""


def read(run):
    return 1e3 * sum(run.spans) / len(run.spans) if run.spans else None
