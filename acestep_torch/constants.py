"""Shared constants for the ACE-Step PyTorch port.

Behavioral parity targets: reference acestep/constants.py (languages,
keyscales, metadata ranges, task types, instruction templates, SFT prompt).
"""

# ------------------------------------------------------------------
# Audio / latent geometry (the reference model invariants)
# ------------------------------------------------------------------

SAMPLE_RATE = 48_000          # Hz, stereo
AUDIO_CHANNELS = 2
LATENT_RATE = 25              # latent frames per second
LATENT_DIM = 64               # VAE latent channels
VAE_HOP = SAMPLE_RATE // LATENT_RATE  # 1920 samples per latent frame
CODE_RATE = 5                 # semantic codes per second (5 Hz)
POOL_WINDOW = 5               # latent frames pooled per code
FSQ_LEVELS = (8, 8, 8, 5, 5, 5)
NUM_AUDIO_CODES = 64_000      # prod(FSQ_LEVELS)

# ------------------------------------------------------------------
# Languages (reference constants.py:13-20)
# ------------------------------------------------------------------

VALID_LANGUAGES = [
    'ar', 'az', 'bg', 'bn', 'ca', 'cs', 'da', 'de', 'el', 'en',
    'es', 'fa', 'fi', 'fr', 'he', 'hi', 'hr', 'ht', 'hu', 'id',
    'is', 'it', 'ja', 'ko', 'la', 'lt', 'ms', 'ne', 'nl', 'no',
    'pa', 'pl', 'pt', 'ro', 'ru', 'sa', 'sk', 'sr', 'sv', 'sw',
    'ta', 'te', 'th', 'tl', 'tr', 'uk', 'ur', 'vi', 'yue', 'zh',
    'unknown',
]

# ------------------------------------------------------------------
# Keyscales (reference constants.py:28-42): 7 notes x 5 accidentals x 2 modes
# ------------------------------------------------------------------

KEYSCALE_NOTES = ['A', 'B', 'C', 'D', 'E', 'F', 'G']
KEYSCALE_ACCIDENTALS = ['', '#', 'b', '♯', '♭']
KEYSCALE_MODES = ['major', 'minor']
VALID_KEYSCALES = {
    f"{note}{acc} {mode}"
    for note in KEYSCALE_NOTES
    for acc in KEYSCALE_ACCIDENTALS
    for mode in KEYSCALE_MODES
}

# ------------------------------------------------------------------
# Metadata ranges (reference constants.py:52-66)
# ------------------------------------------------------------------

BPM_MIN = 30
BPM_MAX = 300
DURATION_MIN = 10
DURATION_MAX = 600
VALID_TIME_SIGNATURES = [2, 3, 4, 6]

# ------------------------------------------------------------------
# Tasks / modes (reference constants.py:74-109)
# ------------------------------------------------------------------

TASK_TYPES = ["text2music", "repaint", "cover", "extract", "lego", "complete"]
TASK_TYPES_TURBO = ["text2music", "repaint", "cover"]
TASK_TYPES_BASE = TASK_TYPES

GENERATION_MODES_TURBO = ["Simple", "Custom", "Remix", "Repaint"]
GENERATION_MODES_BASE = GENERATION_MODES_TURBO + ["Extract", "Lego", "Complete"]

MODE_TO_TASK_TYPE = {
    "Simple": "text2music",
    "Custom": "text2music",
    "Remix": "cover",
    "Repaint": "repaint",
    "Extract": "extract",
    "Lego": "lego",
    "Complete": "complete",
}

# ------------------------------------------------------------------
# Instructions (reference constants.py:117-136)
# ------------------------------------------------------------------

DEFAULT_DIT_INSTRUCTION = "Fill the audio semantic mask based on the given conditions:"
DEFAULT_LM_INSTRUCTION = "Generate audio semantic tokens based on the given conditions:"
DEFAULT_LM_UNDERSTAND_INSTRUCTION = (
    "Understand the given musical conditions and describe the audio semantics accordingly:"
)
DEFAULT_LM_INSPIRED_INSTRUCTION = (
    "Expand the user's input into a more detailed and specific musical description:"
)
DEFAULT_LM_REWRITE_INSTRUCTION = (
    "Format the user's input into a more detailed and specific musical description:"
)

TASK_INSTRUCTIONS = {
    "text2music": "Fill the audio semantic mask based on the given conditions:",
    "repaint": "Repaint the mask area based on the given conditions:",
    "cover": "Generate audio semantic tokens based on the given conditions:",
    "extract": "Extract the {TRACK_NAME} track from the audio:",
    "extract_default": "Extract the track from the audio:",
    "lego": "Generate the {TRACK_NAME} track based on the audio context:",
    "lego_default": "Generate the track based on the audio context:",
    "complete": "Complete the input track with {TRACK_CLASSES}:",
    "complete_default": "Complete the input track:",
}

TRACK_NAMES = [
    "woodwinds", "brass", "fx", "synth", "strings", "percussion",
    "keyboard", "guitar", "bass", "drums", "backing_vocals", "vocals",
]

# Prompt template for the text conditioning / LM input
# (reference constants.py:157-165).
SFT_GEN_PROMPT = """# Instruction
{}

# Caption
{}

# Metas
{}<|endoftext|>
"""

# ------------------------------------------------------------------
# LM planner models (reference constants.py:184-195)
# ------------------------------------------------------------------

LM_MODEL_NAMES = {
    "0.6B": "acestep-5Hz-lm-0.6B",
    "1.7B": "acestep-5Hz-lm-1.7B",
    "4B": "acestep-5Hz-lm-4B",
}

# ------------------------------------------------------------------
# Turbo sampler schedules
# (reference models/turbo/modeling_acestep_v15_turbo.py:1807-1823)
# ------------------------------------------------------------------

VALID_SHIFTS = (1.0, 2.0, 3.0)

VALID_TIMESTEPS = (
    1.0, 0.9545454545454546, 0.9333333333333333, 0.9, 0.875,
    0.8571428571428571, 0.8333333333333334, 0.7692307692307693, 0.75,
    0.6666666666666666, 0.6428571428571429, 0.625, 0.5454545454545454,
    0.5, 0.4, 0.375, 0.3, 0.25, 0.2222222222222222, 0.125,
)

SHIFT_TIMESTEPS = {
    1.0: (1.0, 0.875, 0.75, 0.625, 0.5, 0.375, 0.25, 0.125),
    2.0: (1.0, 0.9333333333333333, 0.8571428571428571, 0.7692307692307693,
          0.6666666666666666, 0.5454545454545454, 0.4, 0.2222222222222222),
    3.0: (1.0, 0.9545454545454546, 0.9, 0.8333333333333334, 0.75,
          0.6428571428571429, 0.5, 0.3),
}
