"""Builders of the program under test from a configuration file."""
