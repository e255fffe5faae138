"""The general generators. A traffic mix's data file names one under
``generator``; the generator reads the mix's parameters, builds the program's
objects and inputs from the seed, drives the measured window through the
program's own entry points, and compares what the window produced with
the plain reference."""
