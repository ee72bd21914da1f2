"""Core host-side types: exact resource arithmetic, configuration, job/node/queue specs."""
