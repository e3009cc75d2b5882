"""Training of the port (`repro.train`): the microbatched update and the
loop, the step functions, checkpoint/restart and fault tolerance."""
