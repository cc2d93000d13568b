"""A snapshot of the port's plain modules (see ``portbench/reference``)."""
