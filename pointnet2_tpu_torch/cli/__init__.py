"""Command-line tools of the port: ``cli.train`` and ``cli.evaluate``."""
