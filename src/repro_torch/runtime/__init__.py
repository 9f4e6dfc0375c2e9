"""Runtime support of the port: the fault-tolerance helpers it needs."""
