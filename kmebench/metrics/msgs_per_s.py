"""msgs_per_s: messages whose closing OUT record reached the consumer
inside the window, over the window's seconds."""


def read(run):
    return run.completed() / run.seconds
