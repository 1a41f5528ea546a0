"""The general drivers, one per kind of traffic (``batch``, ``stream``,
``serve``); a traffic mix names its driver and gives its parameters."""
