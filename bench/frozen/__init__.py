"""Frozen copies of the program's traffic generator, workload profiles,
kernel work arithmetic and the card's published peaks: the yardstick lives
here, where a change to the program cannot move it."""
