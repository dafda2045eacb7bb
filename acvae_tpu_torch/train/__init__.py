"""Schedules and the train step of the flagship recipe."""
