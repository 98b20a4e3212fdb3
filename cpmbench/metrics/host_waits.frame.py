"""host_waits.frame: the host's waits for the card per interaction, as
torch's sync debug mode reports them over a few interactions after the
traced window."""


def read(run):
    return run.host_waits
