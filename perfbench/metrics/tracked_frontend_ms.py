"""Mean per traced point of the tracked route's front end, in ms: the sum of
the point's ``draws`` span (``point_draws``) and ``frontend`` span
(``_proposed_frontend``: the dictionaries and the hyper-parameters of those
draws), each on the host's clock between two synchronisations."""


def read(record):
    draws = [s.seconds for s in record.spans if s.name == "draws"]
    frontends = [s.seconds for s in record.spans if s.name == "frontend"]
    if not draws or not frontends:
        return None
    return 1e3 * (sum(draws) + sum(frontends)) / len(frontends)
