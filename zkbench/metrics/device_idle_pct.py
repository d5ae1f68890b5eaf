"""Share (%) of the traced window with nothing running on the device."""

from zkbench.readings import idle_pct


def read(obs):
    return idle_pct(obs)
