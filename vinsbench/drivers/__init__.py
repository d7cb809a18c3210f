"""Ways of driving the port, one module each, named by a traffic file's
``driver``: ``run(ctx) -> harness.Outcome``."""
