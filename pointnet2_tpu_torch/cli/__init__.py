"""Command-line tools of the port: ``cli.train``, ``cli.evaluate``,
``cli.supervise``, ``cli.visualize`` and ``cli.plot_metrics``."""
