"""Schedules, optimizers, the train step and the Trainer."""
