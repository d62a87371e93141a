"""Fleets on one card: many robots in one step, each with its own map (`fleet`) or all
building one map (`shared`)."""
