"""The benchmark's own machinery: the cell's specification, the window's
clock, the device trace, the published peaks and the casts' reckoner.
Nothing here imports the program at module level."""
