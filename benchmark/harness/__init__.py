"""The benchmark's own machinery: finding a cell's files, the measured
window, the trace, the check and what it takes from the program."""
