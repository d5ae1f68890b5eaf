"""Seconds the service's start spent constructing the prover (its
`startup_s["prover_construction"]`)."""


def read(obs):
    return obs.startup_s.get("prover_construction")
