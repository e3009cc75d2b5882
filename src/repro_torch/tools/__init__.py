"""Tools over the port's launchers (port of the repo's ``tools/``)."""
