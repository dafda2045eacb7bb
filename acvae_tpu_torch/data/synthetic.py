"""Synthetic Clotho-style corpora (counterpart of
``acvae_tpu/data/synthetic.py``): the same numpy draws in the same order, so
a seed gives the JAX package's features, captions and vocabulary.

Each clip holds 1-2 (small grammar) or 1-3 (rich) "events"; an event stamps
a band-limited energy pattern into the log-mel and a phrase into each of
the clip's captions, so the captions follow from the audio.  The rich
corpus varies nouns, verbs, adverbs, places, templates and joiners across
a clip's captions (~200 words), so references disagree on wording as human
captions do.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from acvae_tpu_torch.data.vocab import Vocabulary, build_vocab

_EVENTS = [
    ("dog", "barking loudly"),
    ("rain", "falling on a roof"),
    ("car", "driving past quickly"),
    ("birds", "singing in trees"),
    ("people", "talking in a room"),
    ("water", "flowing down a stream"),
    ("wind", "blowing through leaves"),
    ("machine", "humming steadily"),
]
_TEMPLATES = [
    "a {} is {}",
    "the {} is {}",
    "some {} can be heard {}",
    "a {} keeps {}",
    "there is a {} {}",
]


def make_synthetic_clotho(num_audios: int = 12, captions_per_audio: int = 5,
                          mel_frames: int = 256, mel_bins: int = 64,
                          seed: int = 0
                          ) -> Tuple[Dict[str, np.ndarray], List[dict], Vocabulary]:
    """Returns (features {audio_id: [T, F]}, caption_info, vocabulary)."""
    rng = np.random.default_rng(seed)
    features: Dict[str, np.ndarray] = {}
    caption_info: List[dict] = []
    for a in range(num_audios):
        audio_id = f"synthetic_{a:04d}.wav"
        n_events = int(rng.integers(1, 3))
        event_ids = rng.choice(len(_EVENTS), size=n_events, replace=False)
        T = int(mel_frames * (0.5 + 0.5 * rng.random())) // 32 * 32
        T = max(T, 64)
        mel = rng.normal(-4.0, 0.5, size=(T, mel_bins)).astype(np.float32)
        for k, e in enumerate(event_ids):
            # event e stamps energy into its own frequency band
            band = slice(int(e * mel_bins / len(_EVENTS)),
                         int((e + 1) * mel_bins / len(_EVENTS)))
            t0 = int(rng.integers(0, max(T // 2, 1)))
            t1 = min(T, t0 + T // 2)
            mod = 1.0 + 0.5 * np.sin(
                np.linspace(0, (e + 2) * np.pi, t1 - t0))[:, None]
            mel[t0:t1, band] += 4.0 * mod.astype(np.float32)
        features[audio_id] = mel
        captions = []
        for c in range(captions_per_audio):
            phrases = [_TEMPLATES[(c + k) % len(_TEMPLATES)].format(*_EVENTS[e])
                       for k, e in enumerate(event_ids)]
            text = " and ".join(phrases)
            captions.append({"cap_id": c + 1, "caption": text})
        caption_info.append({"audio_id": audio_id, "captions": captions})
    vocab = build_vocab(caption_info)
    return features, caption_info, vocab


# the rich corpus: each event is (nouns, verbs, adverbs); event e stamps
# band e % 8 at a modulation rate of 2 + (e // 8) * 3 cycles
_RICH_EVENTS = [
    (("dog", "hound", "puppy"), ("barking", "howling", "yapping"),
     ("loudly", "repeatedly")),
    (("rain", "rainfall", "drizzle"), ("falling", "pattering", "dripping"),
     ("steadily", "softly")),
    (("car", "vehicle", "automobile"), ("driving", "passing", "speeding"),
     ("quickly", "noisily")),
    (("birds", "songbirds", "sparrows"), ("singing", "chirping", "tweeting"),
     ("cheerfully", "constantly")),
    (("people", "voices", "crowd"), ("talking", "chatting", "murmuring"),
     ("quietly", "excitedly")),
    (("water", "stream", "creek"), ("flowing", "rushing", "trickling"),
     ("gently", "continuously")),
    (("wind", "breeze", "gust"), ("blowing", "whistling", "rustling"),
     ("strongly", "faintly")),
    (("machine", "engine", "motor"), ("humming", "whirring", "droning"),
     ("steadily", "monotonously")),
    (("thunder", "storm", "thunderstorm"), ("rumbling", "booming", "crashing"),
     ("distantly", "violently")),
    (("children", "kids", "youngsters"), ("playing", "laughing", "shouting"),
     ("happily", "wildly")),
    (("door", "gate", "hinge"), ("creaking", "slamming", "squeaking"),
     ("slowly", "suddenly")),
    (("bell", "chime", "gong"), ("ringing", "tolling", "clanging"),
     ("brightly", "rhythmically")),
    (("train", "locomotive", "railcar"), ("rattling", "rolling", "clattering"),
     ("heavily", "rhythmically")),
    (("insects", "crickets", "cicadas"), ("buzzing", "chirring", "droning"),
     ("incessantly", "softly")),
    (("footsteps", "boots", "heels"), ("walking", "stomping", "shuffling"),
     ("slowly", "briskly")),
    (("fire", "flames", "campfire"), ("crackling", "popping", "hissing"),
     ("warmly", "sporadically")),
    (("waves", "surf", "tide"), ("crashing", "breaking", "lapping"),
     ("rhythmically", "forcefully")),
    (("horse", "pony", "stallion"), ("galloping", "trotting", "neighing"),
     ("swiftly", "heavily")),
    (("airplane", "jet", "aircraft"), ("flying", "roaring", "soaring"),
     ("overhead", "distantly")),
    (("clock", "timepiece", "pendulum"), ("ticking", "chiming", "clicking"),
     ("regularly", "quietly")),
    (("frogs", "toads", "bullfrogs"), ("croaking", "calling", "ribbiting"),
     ("loudly", "intermittently")),
    (("hammer", "tool", "mallet"), ("pounding", "striking", "tapping"),
     ("forcefully", "repeatedly")),
    (("siren", "alarm", "horn"), ("wailing", "blaring", "sounding"),
     ("urgently", "piercingly")),
    (("paper", "pages", "newspaper"), ("rustling", "crinkling", "tearing"),
     ("softly", "briefly")),
]
_RICH_LOCATIONS = [
    "in the distance", "near a busy road", "inside a large room",
    "outside the window", "by the riverside", "in the forest",
    "at the market", "under a bridge", "across the street", "in the yard",
    "along the shore", "behind the house", "on a quiet morning",
    "throughout the night", "during a storm", "in the background",
]
_RICH_TEMPLATES = [
    "a {n} is {v}{adv}{loc}",
    "the {n} keeps {v}{adv}{loc}",
    "some {n} can be heard {v}{adv}{loc}",
    "there is a {n} {v}{adv}{loc}",
    "a {n} {v}{adv} somewhere{loc}",
    "you can hear a {n} {v}{adv}{loc}",
]
_RICH_JOINERS = [" and ", " while ", " as "]


def make_synthetic_clotho_rich(num_audios: int = 12,
                               captions_per_audio: int = 5,
                               mel_frames: int = 256, mel_bins: int = 64,
                               seed: int = 0
                               ) -> Tuple[Dict[str, np.ndarray],
                                          List[dict], Vocabulary]:
    """The rich corpus: same return contract as
    :func:`make_synthetic_clotho`."""
    rng = np.random.default_rng(seed)
    n_ev = len(_RICH_EVENTS)
    n_bands = 8
    band_w = mel_bins // n_bands
    features: Dict[str, np.ndarray] = {}
    caption_info: List[dict] = []
    for a in range(num_audios):
        audio_id = f"synthetic_rich_{a:05d}.wav"
        n_events = int(rng.integers(1, 4))
        event_ids = rng.choice(n_ev, size=n_events, replace=False)
        T = int(mel_frames * (0.5 + 0.5 * rng.random())) // 32 * 32
        T = max(T, 64)
        mel = rng.normal(-4.0, 0.5, size=(T, mel_bins)).astype(np.float32)
        for e in event_ids:
            band = slice((e % n_bands) * band_w, (e % n_bands + 1) * band_w)
            cycles = 2 + (e // n_bands) * 3
            t0 = int(rng.integers(0, max(T // 2, 1)))
            t1 = min(T, t0 + T // 2)
            mod = 1.0 + 0.5 * np.sin(
                np.linspace(0, cycles * np.pi, t1 - t0))[:, None]
            mel[t0:t1, band] += 4.0 * mod.astype(np.float32)
        features[audio_id] = mel
        captions = []
        for c in range(captions_per_audio):
            phrases = []
            for e in event_ids:
                nouns, verbs, advs = _RICH_EVENTS[e]
                adv = (" " + str(rng.choice(advs))
                       if rng.random() < 0.7 else "")
                loc = (" " + str(rng.choice(_RICH_LOCATIONS))
                       if rng.random() < 0.5 else "")
                tpl = str(rng.choice(_RICH_TEMPLATES))
                phrases.append(tpl.format(n=str(rng.choice(nouns)),
                                          v=str(rng.choice(verbs)),
                                          adv=adv, loc=loc))
            text = phrases[0]
            for p in phrases[1:]:
                text += str(rng.choice(_RICH_JOINERS)) + p
            captions.append({"cap_id": c + 1, "caption": text})
        caption_info.append({"audio_id": audio_id, "captions": captions})
    vocab = build_vocab(caption_info)
    return features, caption_info, vocab
