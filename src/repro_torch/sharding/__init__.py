"""Sharding of the port (`repro.sharding`): the logical-axis rules as data
(`rules`) and the DTensor placement of trees on a process mesh
(`dtensor`)."""
